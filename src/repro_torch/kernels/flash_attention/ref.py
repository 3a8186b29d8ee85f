"""Plain torch oracle for flash attention (materializes full scores).

Causal alignment here is bottom-right (``tril(k=Skv-Sq)``), as in the
JAX package's ``ref.py``; the kernel and its plain version in
`flash_attention` align top-left, as the Pallas kernel does.  The two
agree when ``Sq == Skv``.
"""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, H, Sq, D); k, v: (B, Hk, Skv, D). GQA by head repeat."""
    B, H, Sq, D = q.shape
    _, Hk, Skv, _ = k.shape
    scale = (D ** -0.5) if scale is None else scale
    if Hk != H:
        rep = H // Hk
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=Skv - Sq)
        s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
