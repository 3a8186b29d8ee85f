"""Execution-backend registry — select a target per call or per tensor.

The port pairs two backends over one RTCG pipeline, as the JAX package
pairs ``pallas`` and ``xla``:

  * ``cuda``  — the counterpart of ``pallas``: the IR renders to CUDA C,
    ``nvcc`` compiles it for ``sm_90a`` at run time, ``ctypes`` loads it;
  * ``eager`` — the counterpart of ``xla``: the same snippets as plain
    torch operations (``block_sensitive=False``).  It is the plain
    version of every CUDA kernel: the CPU tests run it, and the chip
    check compares the kernels with it.

Resolution: pass ``backend="cuda"``/``"eager"`` (a name or a `Backend`)
to a kernel family, or set ``REPRO_TORCH_BACKEND`` for the process.
Otherwise the operand decides: CUDA tensors run ``cuda``, CPU tensors
run ``eager``.  A CUDA tensor reaches ``eager`` only when the caller
names it; ``cuda`` given a CPU tensor raises — no path falls back.
"""

from __future__ import annotations

import os
from typing import Callable

from repro_torch.core.backends.base import (Backend, ElementwiseSpec,
                                            ReductionSpec)
from repro_torch.core.backends.cuda import CudaBackend
from repro_torch.core.backends.eager import EagerBackend

_FACTORIES: dict[str, Callable[[], Backend]] = {
    "cuda": CudaBackend,
    "eager": EagerBackend,
}
_INSTANCES: dict[str, Backend] = {}

#: the process-wide selection (own name: the JAX package's suites set
#: REPRO_BACKEND in the same test process)
ENV_VAR = "REPRO_TORCH_BACKEND"


def available_backends() -> list[str]:
    return sorted(_FACTORIES)


def active_backend_name() -> "str | None":
    """The process-wide selection from ``REPRO_TORCH_BACKEND``, or
    ``None`` (resolve per operand)."""
    env = os.environ.get(ENV_VAR, "").strip().lower()
    return env or None


def backend_for_device(device) -> str:
    """The default backend of a tensor's device."""
    return "cuda" if getattr(device, "type", str(device)) == "cuda" \
        else "eager"


def get_backend(name: "str | Backend | None" = None, operand=None) -> Backend:
    """Resolve a backend: an instance passes through, a name looks up the
    registry; ``None`` reads ``REPRO_TORCH_BACKEND`` and then the device
    of ``operand`` (a tensor; anything else counts as CPU)."""
    if isinstance(name, Backend):
        return name
    key = (name or active_backend_name()
           or backend_for_device(getattr(operand, "device", "cpu"))).lower()
    be = _INSTANCES.get(key)
    if be is None:
        if key == "auto":
            raise NotImplementedError(
                "backend='auto' (the latency router) is ported with "
                "ROADMAP Queue 1 item 2")
        try:
            factory = _FACTORIES[key]
        except KeyError:
            raise ValueError(f"unknown RTCG backend {key!r}; available: "
                             f"{available_backends()}") from None
        be = _INSTANCES[key] = factory()
    return be


__all__ = [
    "Backend", "ElementwiseSpec", "ReductionSpec", "CudaBackend",
    "EagerBackend", "ENV_VAR", "available_backends", "active_backend_name",
    "backend_for_device", "get_backend",
]
