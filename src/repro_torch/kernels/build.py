"""Build the CUDA kernels at first use.

Every ``csrc/*.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries go to ``build/kernels/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is not.  All
missing libraries are compiled together, one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

# sm_90a: Hopper.  --fmad=false keeps every multiply and add separately
# rounded, as the oracle computes them; fast math stays off (IEEE division).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_FAILED: dict[str, str] = {}      # source -> nvcc log of a failed build
# source -> wall seconds of its nvcc in the last build_all
BUILD_SECONDS: dict[str, float] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[3] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest()}.so"


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all at once.  Returns
    each compiled source's ``nvcc`` output (``-Xptxas=-v`` register and
    spill report), and leaves each one's wall seconds in
    ``BUILD_SECONDS``; raises ``RuntimeError`` with the log if one
    fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        lib = lib_path(src.stem)
        if lib.exists() or src.stem in _FAILED:
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[src.stem] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    outs, failed = {}, []

    def wait(name, proc):
        outs[name] = proc.communicate()[0]
        BUILD_SECONDS[name] = time.perf_counter() - t0

    waits = [threading.Thread(target=wait, args=(name, proc))
             for name, (proc, _, _) in procs.items()]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    logs = {name: outs[name] for name in procs}
    for name, (proc, tmp, lib) in procs.items():
        if proc.returncode:
            failed.append(name)
            _FAILED[name] = logs[name]
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[f] for f in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if name in _FAILED:     # not compiled again in this process
            raise RuntimeError(f"nvcc failed for {name}:\n{_FAILED[name]}")
        path = lib_path(name)
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
