"""PyTorch/CUDA port of the FaaS call-scheduling simulator.

A package of its own beside the JAX package ``repro``: it imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.  It mirrors the JAX
package's module names so that each module's counterpart is easy to find.

Device rule: every entry point takes ``device=``.  It defaults to CUDA; with
no card the call raises ``RuntimeError`` unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
