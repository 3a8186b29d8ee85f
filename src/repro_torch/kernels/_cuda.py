"""Build, bind and launch the hand-written kernels of `repro_torch.kernels`.

Each kernel's source is a template under ``repro_torch/csrc``; a kernel
instance is the template rendered with its compile-time constants,
compiled by `CudaSourceModule` (``nvcc`` for ``sm_90a`` at first use,
content-addressed under the build directory) and called through the
``extern "C"`` launch function with `ctypes`.  Nothing here runs at
import: the CPU tests import every module.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

from repro_torch.core import dispatch
from repro_torch.core.rtcg import CudaSourceModule, check_launch
from repro_torch.core.templates import KernelTemplate

_lock = threading.Lock()
_entries: dict = {}


def launcher(template: KernelTemplate, name: str, argtypes,
             **params) -> Callable:
    """The ctypes launch function ``<name>_launch`` of ``template``
    rendered with ``name`` and ``params``; built on first use, then
    cached per (template, name)."""
    key = (template.entrypoint, name)
    fn = _entries.get(key)
    if fn is None:
        src = template.render(name=name, **params)
        mod = CudaSourceModule.load(src, name=name)
        fn = mod.get_function(f"{name}_launch", argtypes)
        with _lock:
            fn = _entries.setdefault(key, fn)
    return fn


def launched(kernel: str, name: str, err: int) -> None:
    """Raise on a non-zero CUDA error code from a launch function; count
    the launch of ``kernel`` otherwise."""
    check_launch(err, name)
    dispatch.record_kernel_launch(kernel)


def aligned(t: torch.Tensor, elems: int) -> bool:
    """16-byte loads are safe on ``t``: its address is 16-byte aligned
    and every stride but the last (which is 1) is a multiple of
    ``elems`` elements (a dimension of size 1 has no stride to step)."""
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(s % elems == 0 or n == 1
                    for s, n in zip(t.stride()[:-1], t.shape[:-1])))
