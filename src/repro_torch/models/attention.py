"""Attention: chunked flash-style path, naive path, and KV-cache decode.

The port of the JAX package's ``models/attention.py`` for the dense
decoder, with the same arithmetic: float32 scores, GQA by repeating each
KV head ``H // Hk`` times (``repeat_interleave``, as ``jnp.repeat``),
the causal and ``col <= pos`` masks with ``NEG_INF``.  Inside the model
the softmax is ``torch.softmax`` — what the jitted JAX path runs
(``jax.nn.softmax`` under trace).  No library attention kernel is used.
``attention_impl="pallas"`` runs prefill through the hand-written
flash-attention kernel (`repro_torch.kernels.flash_attention`): on a
CUDA tensor the CUDA kernel, on a CPU tensor its plain version.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


def _gqa_expand(k, H):
    """(B, S, Hk, dh) -> (B, S, H, dh) by group repeat."""
    Hk = k.shape[2]
    if Hk == H:
        return k
    return torch.repeat_interleave(k, H // Hk, dim=2)


def naive_attention(q, k, v, *, causal: bool, scale: float):
    """q: (B, S, H, dh); k/v: (B, Skv, Hk, dh). Full score matrix."""
    H = q.shape[2]
    k, v = _gqa_expand(k, H), _gqa_expand(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Sq, Skv = q.shape[1], k.shape[1]
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=Skv - Sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _flash_q_chunk(q, k, v, *, q_start, kv_chunk, causal, scale):
    """Online softmax over KV chunks for one q chunk.
    q: (B, qc, H, dh); k/v: (B, Skv, H, dh) [already GQA-expanded]."""
    B, qc, H, dh = q.shape
    Skv = k.shape[1]
    m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, qc, dh), dtype=torch.float32, device=q.device)
    row = q_start + torch.arange(qc, device=q.device)[:, None]
    for j in range(Skv // kv_chunk):
        kb = k[:, j * kv_chunk:(j + 1) * kv_chunk]
        vb = v[:, j * kv_chunk:(j + 1) * kv_chunk]
        # float32 products of the operands' values, float32 accumulation
        # (the JAX path's preferred_element_type=float32)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float()) * scale
        if causal:
            col = j * kv_chunk + torch.arange(kv_chunk, device=q.device)[None]
            s = torch.where(row >= col, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).to(q.dtype)               # (B, H, qc, dh)
    return out.transpose(1, 2)                           # (B, qc, H, dh)


def flash_attention_jnp(q, k, v, *, causal: bool, scale: float,
                        q_chunk: int, kv_chunk: int):
    """The counterpart of the JAX package's chunked jnp flash path (the
    default ``attention_impl``): q: (B, S, H, dh); k/v: (B, Skv, Hk, dh)."""
    B, S, H, dh = q.shape
    Skv = k.shape[1]
    k, v = _gqa_expand(k, H), _gqa_expand(v, H)
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, Skv)
    if S % q_chunk or Skv % kv_chunk:
        return naive_attention(q, k, v, causal=causal, scale=scale)
    return torch.cat([
        _flash_q_chunk(q[:, i:i + q_chunk], k, v, q_start=i,
                       kv_chunk=kv_chunk, causal=causal, scale=scale)
        for i in range(0, S, q_chunk)], dim=1)


def decode_attention(q, k_cache, v_cache, pos, *, scale: float):
    """Single-token decode. q: (B, 1, H, dh); caches: (B, Smax, Hk, dh);
    pos: int or (B,) — cache columns ``<= pos`` attend."""
    B, _, H, dh = q.shape
    Smax = k_cache.shape[1]
    qg = q.reshape(B, H, dh).float()
    s = torch.einsum("bhd,bshd->bhs", qg,
                     _gqa_expand(k_cache.float(), H)) * scale   # (B, H, Smax)
    col = torch.arange(Smax, device=q.device)
    valid = col[None, :] <= torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, _gqa_expand(v_cache.float(), H))
    return out.reshape(B, 1, H, dh).to(q.dtype)


def attention(cfg: ModelConfig, q, k, v, *, causal: bool):
    """Prefill dispatch. q: (B,S,H,dh); k/v: (B,Skv,Hk,dh)."""
    scale = cfg.dh ** -0.5
    impl = cfg.attention_impl
    if impl == "pallas":
        # the kernel's layout is (B, H, S, D): strided views, no copies
        o = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=causal)
        return o.transpose(1, 2)
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention_jnp(q, k, v, causal=causal, scale=scale,
                               q_chunk=cfg.attn_q_chunk,
                               kv_chunk=cfg.attn_kv_chunk)
