"""Decoder stack: prefill and KV-cache decode for dense attention models.

The port of the JAX package's ``models/transformer.py`` for the
decoder the port serves (attention mixer + dense MLP, no encoder).  The
JAX package scans one compiled layer body over the stacked per-period
parameters; the port runs a Python loop over the same stacked leaves,
indexing layer ``l`` of each (see `schema`).  The KV cache keeps the JAX
layout ``(P, B, max_len, Hk, dh)`` per slot and is written IN PLACE —
``cache["k"][:, pos] = k`` — where the JAX package returns an updated
copy; callers that need the old cache keep their own copy.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.platform import canonical_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import dense_mlp, norm, position_encode
from repro_torch.models.schema import _check_supported, decoder_period, slot_plan


# ------------------------------------------------------------ attention mixer
def _qkv(cfg: ModelConfig, p, x, positions):
    B, S, _ = x.shape
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.dh
    q = torch.einsum("bsd,de->bse", x, p["wq"])
    k = torch.einsum("bsd,de->bse", x, p["wk"])
    v = torch.einsum("bsd,de->bse", x, p["wv"])
    if cfg.use_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = position_encode(cfg, q.reshape(B, S, H, dh), positions)
    k = position_encode(cfg, k.reshape(B, S, Hk, dh), positions)
    return q, k, v.reshape(B, S, Hk, dh)


def attn_mixer(cfg: ModelConfig, p, x, positions, *, cache=None, pos=None,
               mode="prefill"):
    """-> out; ``cache`` (this layer's ``{"k", "v"}`` views) is written
    in place: the new column at ``pos`` (decode) or the whole prompt
    (prefill)."""
    q, k, v = _qkv(cfg, p, x, positions)
    if mode == "decode":
        cache["k"][:, pos:pos + 1] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + 1] = v.to(cache["v"].dtype)
        y = attn_mod.decode_attention(q, cache["k"], cache["v"], pos,
                                      scale=cfg.dh ** -0.5)
    else:
        y = attn_mod.attention(cfg, q, k, v, causal=True)
        if cache is not None:
            S = k.shape[1]
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
    B, S = y.shape[:2]
    out = torch.einsum("bse,ed->bsd", y.reshape(B, S, -1), p["wo"])
    if cfg.use_bias:
        out = out + p["bo"].to(out.dtype)
    return out


def apply_slot(cfg: ModelConfig, p: dict, x, positions, *, mode="prefill",
               cache=None, pos=None):
    """Residual block: norm -> attention -> +res; norm -> mlp -> +res."""
    h = norm(cfg, p, "norm1", x)
    x = x + attn_mixer(cfg, p, h, positions, cache=cache, pos=pos, mode=mode)
    h = norm(cfg, p, "norm2", x)
    return x + dense_mlp(cfg, p, h)


def decoder_apply(cfg: ModelConfig, dec_params: dict, x, positions, *,
                  mode="prefill", cache=None, pos=None):
    """Loop over periods; dec_params/cache leaves have a leading
    num_periods axis, indexed per period."""
    plan = slot_plan(cfg)
    num_periods = cfg.num_layers // decoder_period(cfg)
    for l in range(num_periods):
        for s in range(len(plan)):
            p_slot = {k: v[l] for k, v in dec_params[f"slot_{s}"].items()}
            c_slot = (None if cache is None else
                      {k: v[l] for k, v in cache[f"slot_{s}"].items()})
            x = apply_slot(cfg, p_slot, x, positions, mode=mode,
                           cache=c_slot, pos=pos)
    return x


# ------------------------------------------------------------------ forward
def forward(cfg: ModelConfig, params, batch: dict, *, mode: str = "prefill",
            cache=None, pos=None):
    """mode: prefill | decode.  batch: ``{"tokens": (B, S) int}``.
    -> ``{"x": final hidden (B, S, d), "cache": cache}``."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r}: training is ROADMAP Queue 1 item 7")
    _check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embedding"][tokens.long()]
    if mode == "decode":
        positions = torch.full((B, S), int(pos), dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    x = decoder_apply(cfg, params["decoder"], x, positions, mode=mode,
                      cache=cache, pos=pos)
    x = norm(cfg, params, "final_norm", x)
    return {"x": x, "cache": cache}


def logits_from_hidden(cfg: ModelConfig, params, x):
    """The head product in the model dtype, then float32."""
    head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,vd->bsv", x, head).float()


# ------------------------------------------------------------------- caches
def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None):
    """Decode cache: per slot ``{"k", "v"}`` of shape
    ``(num_periods, B, max_len, Hk, dh)`` in the model dtype."""
    P_ = cfg.num_layers // decoder_period(cfg)
    dt = canonical_dtype(cfg.dtype)
    shape = (P_, B, max_len, cfg.num_kv_heads, cfg.dh)
    return {f"slot_{s}": {"k": torch.zeros(shape, dtype=dt, device=device),
                          "v": torch.zeros(shape, dtype=dt, device=device)}
            for s in range(len(slot_plan(cfg)))}


def prefill(cfg: ModelConfig, params, batch, *, max_len: int | None = None):
    """Run the full prompt, return (last-token logits, filled cache)."""
    B, S = batch["tokens"].shape
    cache = init_cache(cfg, B, max_len or S, device=batch["tokens"].device)
    out = forward(cfg, params, batch, mode="prefill", cache=cache)
    logits = logits_from_hidden(cfg, params, out["x"][:, -1:, :])
    return logits[:, 0], out["cache"]


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """One decode step. tokens: (B, 1); pos: the cache column written.
    -> (logits (B, V), cache) — the cache is updated in place."""
    out = forward(cfg, params, {"tokens": tokens}, mode="decode",
                  cache=cache, pos=pos)
    logits = logits_from_hidden(cfg, params, out["x"])
    return logits[:, 0], out["cache"]
