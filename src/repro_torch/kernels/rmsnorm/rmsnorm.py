"""Fused RMSNorm: the hand-written CUDA kernel and its plain version.

The port of the JAX package's ``kernels/rmsnorm/rmsnorm.py``
(``pallas_rmsnorm``): ``x * rsqrt(mean(x^2) + eps) * w`` over the last
axis in float32, with an optional residual added first (only the
normalized output is returned), cast to x's dtype.  A CUDA tensor goes
to the kernel rendered from ``repro_torch/csrc/rmsnorm.cu.j2`` (one
instance per (x dtype, w dtype, residual fused); R, D and eps are
run-time arguments), a CPU tensor to `rmsnorm_ref`.  Nothing falls back
from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.platform import dtype_name
from repro_torch.core.templates import KernelTemplate
from repro_torch.kernels import _cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_TMPL = KernelTemplate.from_file("rmsnorm", "rmsnorm.cu.j2")
DTYPES = (torch.float32, torch.bfloat16)
#: the longest row the kernel keeps in shared memory: float32, rounded up
#: to whole sweeps of 256 threads x 16 bytes, within a block's 227 KB
MAX_D = 56 * 1024

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int]


def instance(dtype: torch.dtype, wdtype: torch.dtype,
             residual: bool) -> tuple[str, dict]:
    """(name, template constants) of one kernel instance."""
    dt, wdt = dtype_name(dtype), dtype_name(wdtype)
    name = f"rmsnorm_{dt}_w{wdt}" + ("_res" if residual else "")
    return name, dict(dtype=dt, wdtype=wdt, residual=residual)


def render(dtype: torch.dtype, wdtype: torch.dtype, residual: bool) -> str:
    name, params = instance(dtype, wdtype, residual)
    return _TMPL.render(name=name, **params)


def cuda_rmsnorm(x, w, residual=None, *, eps: float = 1e-6):
    """The CUDA kernel on (..., D) rows; raises on what it does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"the rmsnorm kernel takes CUDA tensors, got "
                         f"{x.device}")
    others = [w] + ([] if residual is None else [residual])
    if any(t.device != x.device for t in others):
        raise ValueError("x, w and the residual must lie on one device")
    if x.dtype not in DTYPES or w.dtype not in DTYPES:
        raise TypeError(f"the rmsnorm kernel takes float32 or bfloat16, got "
                        f"x {x.dtype}, w {w.dtype}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w has shape {tuple(w.shape)}, rows have {D}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"the residual must match x: {residual.dtype} "
                         f"{tuple(residual.shape)} vs {x.dtype} "
                         f"{tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()
            and (residual is None or residual.is_contiguous())):
        raise ValueError("the rmsnorm kernel takes contiguous tensors")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"row length {D} outside [1, {MAX_D}]")
    R = x.numel() // D
    if R >= 2 ** 31:
        raise ValueError(f"{R} rows exceed the kernel's int range")
    out = torch.empty_like(x)
    if R == 0:
        return out
    # 16-byte loads and stores of x, the residual and out (w is read
    # one element at a time)
    rows = [x, out] + ([] if residual is None else [residual])
    vec = D % (16 // x.element_size()) == 0 and \
        all(t.data_ptr() % 16 == 0 for t in rows)
    name, params = instance(x.dtype, w.dtype, residual is not None)
    launch = _cuda.launcher(_TMPL, name, _ARGTYPES, **params)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(stream, x.data_ptr(), w.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 out.data_ptr(), R, D, float(eps), int(vec))
    _cuda.launched("rmsnorm", name, err)
    return out


def rmsnorm_forward(x, w, residual=None, *, eps: float = 1e-6,
                    block_rows: int = 128):
    """x: (..., D) row-normalized; w: (D,).  Optional fused residual add.
    ``block_rows`` is the TPU kernel's row block: rows are independent,
    so neither the kernel nor the plain version depends on it."""
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    if x.device.type == "cuda":
        return cuda_rmsnorm(x, w, residual, eps=eps)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, residual, eps=eps)
    raise ValueError(f"no rmsnorm for tensors on {x.device}")
