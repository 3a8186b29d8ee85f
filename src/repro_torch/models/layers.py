"""Shared model layers: norms, RoPE, the planner softmax/RMSNorm and the
dense MLP.

The port of the JAX package's ``models/layers.py`` for the dense
decoder: the same arithmetic, in torch (norms in float32 and cast back,
RoPE with split — not interleaved — halves, swiglu or tanh-gelu MLPs).
`fused_softmax` and `rtcg_rmsnorm` are library functions over the fusion
planner (2 generated launches each); the model itself keeps
``torch.softmax``, as the jitted JAX model keeps ``jax.nn.softmax``.
``norm(use_pallas=True)`` runs the fused RMSNorm kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.platform import canonical_dtype
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops


def norm(cfg: ModelConfig, p: dict, name: str, x, *, use_pallas: bool = False,
         use_rtcg: bool = False):
    """RMSNorm (or LayerNorm) over the last axis.  ``use_rtcg`` runs the
    planner-backed `rtcg_rmsnorm`; ``use_pallas`` the fused RMSNorm
    kernel (`repro_torch.kernels.rmsnorm`), with the weight cast to x's
    dtype first, as the JAX package does."""
    w = p[name]
    if cfg.norm_type == "layernorm":
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * w + p[name + "_b"]).to(x.dtype)
    if use_rtcg:
        return rtcg_rmsnorm(x, w, eps=cfg.norm_eps)
    if use_pallas:
        return rmsnorm_ops.rmsnorm(x, w.to(x.dtype), eps=cfg.norm_eps)
    xf = x.float()
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


# ------------------------------------------------------------- softmax
_AUTO = ("backend='auto' (the serving runtime's latency router) is "
         "ported with ROADMAP Queue 1 item 2")


def fused_softmax(x, *, stable: bool = True, backend: "str | None" = None):
    """Softmax along the last axis through the fusion planner: inputs of
    ANY batch shape run as ONE segmented reduction wave plus ONE fused
    2-D epilogue — 2 launches for the whole batch, ``stable=True``
    included (the row max and the shifted-exp sum share one wave).
    ``backend`` pins the execution backend (default: the tensor's
    device decides)."""
    if isinstance(backend, str) and backend.lower() == "auto":
        raise NotImplementedError(_AUTO)
    if x.ndim == 0:
        return torch.softmax(x, dim=-1)
    from repro_torch.core import array as ga

    # the plan computes in float32 whatever the input's type (exp
    # promotes), so binding float32 rows changes no result and lets the
    # CUDA kernels take bf16 inputs too
    rows = x.reshape(-1, x.shape[-1]).to(torch.float32)
    out = ga.softmax(ga.RTCGArray(rows), stable=stable).evaluate(
        backend=backend).value
    return out.reshape(x.shape).to(canonical_dtype(x.dtype))


def rtcg_rmsnorm(x, w, *, eps: float = 1e-6, backend: "str | None" = None):
    """Planner-backed RMSNorm: ``x / sqrt(mean(x^2, -1) + eps) * w`` in
    float32 as ONE segmented reduction wave plus ONE fused 2-D epilogue
    (2 launches), the ``(N,)`` weight broadcast per column and the
    per-row ``mean`` re-entering the epilogue per row; cast back to the
    input dtype."""
    if isinstance(backend, str) and backend.lower() == "auto":
        raise NotImplementedError(_AUTO)
    from repro_torch.core import array as ga

    orig = x.shape
    X = ga.RTCGArray(x.reshape(-1, orig[-1]).to(torch.float32))
    W = ga.RTCGArray(torch.as_tensor(w, device=x.device).to(torch.float32))
    out = (X / (((X * X).mean(axis=-1) + eps).sqrt()) * W).evaluate(
        backend=backend).value
    return out.reshape(orig).to(canonical_dtype(x.dtype))


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
