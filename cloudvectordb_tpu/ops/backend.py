"""The one place that decides how a scan kernel runs.

``scan_impl(interpret)`` →
  - ``"interpret"`` when the caller passed ``interpret=True`` (tests run
    the GPU kernels in the Pallas interpreter on the CPU);
  - ``"triton"`` on the GPU: the compiled kernel runs, or the call fails —
    nothing falls back to the interpreter or the plain form there;
  - ``"xla"`` on any other backend (the CPU has no Triton): the plain
    jnp/lax form of the same scan.
"""

from __future__ import annotations

import jax


def scan_impl(interpret: bool = False, platform: str | None = None) -> str:
    if interpret:
        return "interpret"
    platform = platform or jax.default_backend()
    return "triton" if platform == "gpu" else "xla"
