"""Shared platform/layout vocabulary for the kernel families and backends.

The port's counterpart of the JAX package's ``core/platform.py``: the
dtype rule, the argument kinds, the row geometry and the operand bind
rules shared by the snippet layer (kernel families describing what to
compute) and the backend layer (`repro_torch.core.backends`, deciding
how to launch it).  It depends only on torch/numpy and `snippets`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import snippets

#: bucketing granularity of a row length (the JAX package's TPU lane
#: width, kept so both packages bucket — and count driver builds — alike)
LANES = 128

# JAX with x64 off (its default) computes 64-bit types in 32 bits; the
# port applies the same rule, so both packages agree on every dtype
_X64_OFF = {torch.float64: torch.float32, torch.int64: torch.int32,
            torch.complex128: torch.complex64}


def canonical_dtype(dtype) -> torch.dtype:
    """A torch dtype for ``dtype`` (torch, numpy or name), with the JAX
    x64-off rule: float64 -> float32, int64 -> int32."""
    if not isinstance(dtype, torch.dtype):
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        dtype = getattr(torch, "bool" if name == "bool_" else name)
    return _X64_OFF.get(dtype, dtype)


def dtype_name(dtype) -> str:
    """'float32'-style name of a (canonical) dtype."""
    return str(canonical_dtype(dtype)).replace("torch.", "")


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU:
    ``None`` means ``cuda`` and raises when no GPU is visible — it never
    carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ------------------------------------------------------- argument kinds
@dataclass(frozen=True)
class VectorArg:
    dtype: Any
    name: str

    @property
    def torch_dtype(self) -> torch.dtype:
        return canonical_dtype(self.dtype)


@dataclass(frozen=True)
class ScalarArg:
    dtype: Any
    name: str

    @property
    def torch_dtype(self) -> torch.dtype:
        return canonical_dtype(self.dtype)


@dataclass(frozen=True)
class BroadcastArg:
    """Broadcast vector argument of a *row-layout* kernel over ``(B, N)``
    operands: ``kind='row'`` binds a length-B vector as ``(B, 1)`` (a
    per-row reduced value re-entering fused elementwise code),
    ``kind='col'`` binds a length-N vector as ``(1, N)`` (a per-feature
    weight shared by every row).  In snippets the name is referenced
    bare (no ``[i]``) or as ``name[i]``."""

    dtype: Any
    name: str
    kind: str = "row"  # 'row' -> (B, 1) | 'col' -> (1, N)

    @property
    def torch_dtype(self) -> torch.dtype:
        return canonical_dtype(self.dtype)


def arg_kind(a) -> str:
    if isinstance(a, ScalarArg):
        return "scalar"
    if isinstance(a, BroadcastArg):
        return a.kind
    return "full"


def parse_arguments(arguments) -> list:
    if isinstance(arguments, str):
        out = []
        for name, dtype, is_vec in snippets.parse_c_arguments(arguments):
            out.append(VectorArg(dtype, name) if is_vec else ScalarArg(dtype, name))
        return out
    return list(arguments)


# ------------------------------------------------ geometry + binding
def rows_geometry(first_vec) -> tuple[int, int]:
    """(batch rows, row length) of the leading full vector operand."""
    shape = first_vec.shape
    n = int(shape[-1])
    b = max(1, int(np.prod(shape[:-1]))) if len(shape) > 1 else 1
    return b, n


def bind_row_operand(kind: str, name: str, arg, dt: torch.dtype, b: int,
                     n: int, device: torch.device):
    """Validate one operand against the ``(b, n)`` geometry and bind it
    in the layout both backends take: a full operand as a contiguous
    ``(b, n)`` tensor, a per-row one as ``(b, 1)``, a per-col one as
    ``(1, n)``, a scalar as a 0-d tensor — all of dtype ``dt`` on
    ``device``.  The port's counterpart of the JAX package's
    ``pad_row_operand``, with the same size checks; nothing is padded to
    the bucket, because neither backend's code depends on the bucket
    shape (the CUDA kernels take ``b``, ``n`` and the strides at run
    time)."""
    if isinstance(arg, torch.Tensor) and arg.device != device and (
            kind != "scalar" or arg.numel() != 1):
        raise ValueError(f"argument {name!r} lies on {arg.device}, the "
                         f"leading operand on {device}")
    if kind == "scalar":
        return torch.as_tensor(arg, dtype=dt, device=device).reshape(())
    v = torch.as_tensor(arg, device=device).to(dt)
    if kind == "full":
        if v.numel() != b * n:
            raise ValueError(f"vector argument {name!r} has {v.numel()} "
                             f"elements, expected {b}x{n}")
        return v.reshape(b, n).contiguous()
    if kind == "row":
        if v.numel() != b:
            raise ValueError(f"per-row argument {name!r} has {v.numel()} "
                             f"elements, expected {b} rows")
        return v.reshape(b, 1).contiguous()
    if v.numel() != n:
        raise ValueError(f"per-col argument {name!r} has {v.numel()} "
                         f"elements, expected row length {n}")
    return v.reshape(1, n).contiguous()
