"""Entry point for fused RMSNorm."""

from __future__ import annotations

from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_forward


def rmsnorm(x, w, residual=None, *, eps: float = 1e-6, block_rows: int = 128):
    return rmsnorm_forward(x, w, residual, eps=eps, block_rows=block_rows)
