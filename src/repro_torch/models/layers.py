"""Shared model layers: norms, RoPE and the dense MLP.

The port of the JAX package's ``models/layers.py`` for the dense
decoder: the same arithmetic, in torch (norms in float32 and cast back,
RoPE with split — not interleaved — halves, swiglu or tanh-gelu MLPs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def norm(cfg: ModelConfig, p: dict, name: str, x):
    w = p[name]
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * w + p[name + "_b"]).to(x.dtype)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + cfg.norm_eps) * w).to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope_freqs(dh: int, theta: float, device=None):
    exps = -torch.arange(0, dh // 2, dtype=torch.float32, device=device) \
        / (dh // 2)
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, dh); positions: (B, S) int."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    ang = positions[..., None].float() * inv               # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def position_encode(cfg: ModelConfig, x, positions):
    """q/k rotary application. positions: (B, S)."""
    if cfg.pos_type == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    return x


# ---------------------------------------------------------------- MLPs
def dense_mlp(cfg: ModelConfig, p: dict, x):
    if cfg.mlp_type == "swiglu":
        h = torch.einsum("bsd,df->bsf", x, p["w1"])
        g = torch.einsum("bsd,df->bsf", x, p["w3"])
        return torch.einsum("bsf,fd->bsd", F.silu(h) * g, p["w2"])
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if cfg.use_bias:
        h = h + p["bi"].to(h.dtype)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h, approximate="tanh")
    out = torch.einsum("bsf,fd->bsd", h, p["wo_mlp"])
    if cfg.use_bias:
        out = out + p["bo_mlp"].to(out.dtype)
    return out
