"""Plain torch oracle for fused RMSNorm — the CUDA kernel's plain version."""

from __future__ import annotations

import torch


def rmsnorm_ref(x, w, residual=None, eps: float = 1e-6):
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)
