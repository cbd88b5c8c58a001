"""SASS of two trees' CUDA kernels, instantiation by instantiation.

    python3 tools/sass_compare.py --a DIR_A --b DIR_B
                                  [--source NAME ...] [--match REGEX]

Compiles each tree's ``repro_torch/kernels/csrc/<NAME>.cu`` (DIR is a
tree's ``src``; default sources ``event_step`` and ``event_step_stream``)
to a cubin with the port's code flags (sm_90a, ``-O3``, ``--fmad=false``),
disassembles it with ``cuobjdump -sass`` and prints one JSON line a kernel
instantiation whose mangled name matches REGEX (default ``dyn_kernel``):
whether its instructions are the same in both trees, in order (addresses,
encodings and the anonymous namespace's per-file hash left out), and each
side's count of instructions and its registers and spills as ``ptxas -v``
reports them; where they differ, how many positions differ and the first
few pairs.  A last line sums the instantiations that are equal and those
that differ.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); the
cubins go to a temporary directory.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CODE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v")
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
PTXAS_FN = re.compile(r"Compiling entry function '([^']+)'")
PTXAS_REGS = re.compile(r"Used (\d+) registers")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(f"{name} not found")


def compile_all(jobs: list[tuple[Path, Path]]) -> dict[Path, str]:
    """nvcc every (source, cubin) pair at once; returns each cubin's ptxas
    report."""
    nvcc = tool("nvcc")
    procs = {out: subprocess.Popen([nvcc, *CODE_FLAGS, "-cubin", "-o",
                                    str(out), str(src)],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for src, out in jobs}
    logs = {}
    for out, proc in procs.items():
        logs[out] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {out}:\n{logs[out]}")
    return logs


def functions(cubin: Path) -> dict[str, list[str]]:
    """Each kernel's instructions, by its name (anonymous hash left out)."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    out: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = ANON.sub("_GLOBAL__N_", line.split("Function :")[1].strip())
            out[cur] = []
        elif cur is not None:
            m = INSN.search(line)
            if m:
                out[cur].append(m.group(1))
    return out


def ptxas(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each kernel in a ptxas -v report."""
    out, cur = {}, None
    for line in log.splitlines():
        m = PTXAS_FN.search(line)
        if m:
            cur = ANON.sub("_GLOBAL__N_", m.group(1))
            out[cur] = {}
        elif cur is not None:
            if (m := PTXAS_SPILL.search(line)):
                out[cur]["spill_stores"] = int(m.group(1))
                out[cur]["spill_loads"] = int(m.group(2))
            if (m := PTXAS_REGS.search(line)):
                out[cur]["registers"] = int(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="the first tree's src")
    ap.add_argument("--b", required=True, help="the second tree's src")
    ap.add_argument("--source", action="append",
                    help="csrc/<NAME>.cu to compare (repeatable)")
    ap.add_argument("--match", default="dyn_kernel")
    args = ap.parse_args()
    sources = args.source or ["event_step", "event_step_stream"]
    pat = re.compile(args.match)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for side, src in (("a", args.a), ("b", args.b)):
            csrc = Path(src) / "repro_torch" / "kernels" / "csrc"
            for name in sources:
                jobs[side, name] = (csrc / f"{name}.cu",
                                    Path(tmp) / f"{side}_{name}.cubin")
        logs = compile_all(list(jobs.values()))
        same = differ = 0
        for name in sources:
            fa = functions(jobs["a", name][1])
            fb = functions(jobs["b", name][1])
            ra = ptxas(logs[jobs["a", name][1]])
            rb = ptxas(logs[jobs["b", name][1]])
            for fn in sorted(set(fa) | set(fb)):
                if not pat.search(fn):
                    continue
                ia, ib = fa.get(fn, []), fb.get(fn, [])
                eq = fn in fa and fn in fb and ia == ib
                same += eq
                differ += not eq
                row = {"source": name, "kernel": fn, "equal": eq,
                       "n_a": len(ia), "n_b": len(ib),
                       "a": ra.get(fn), "b": rb.get(fn)}
                if not eq:
                    diffs = [(k, x, y) for k, (x, y) in enumerate(zip(ia, ib))
                             if x != y]
                    row["n_diff"] = len(diffs) + abs(len(ia) - len(ib))
                    row["first_diffs"] = diffs[:4]
                print(json.dumps(row), flush=True)
        print(json.dumps({"equal": same, "differ": differ}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
