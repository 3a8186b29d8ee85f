"""Flash attention forward: the hand-written CUDA kernel and its plain version.

The port of the JAX package's ``kernels/flash_attention/
flash_attention.py`` (``pallas_flash_attention``).  The contract is that
Pallas kernel, not ``ref.attention_ref``:

  * GQA by index: q head ``h`` reads kv head ``h // (H // Hk)``; K and V
    are never repeated per q head;
  * ``s = (q . k) * scale`` with float32 products and sums, ``scale``
    ``D ** -0.5`` by default;
  * causal alignment is top-left — row ``r`` sees columns ``c <= r`` —
    which differs from ``attention_ref``'s ``tril(k=Skv-Sq)`` when
    ``Sq != Skv``; columns ``>= Skv`` are masked;
  * masked scores are the finite `NEG_INF` (-1e30), never -inf;
  * ``m``, ``l`` and ``acc`` are float32, ``p`` is rounded to v's dtype
    before the P.V product, the output is ``acc / l`` with ``l == 0``
    read as 1, cast to q's dtype;
  * with ``skip_masked_blocks`` the kv blocks strictly above the diagonal
    are not visited; the result does not depend on it.

A CUDA tensor goes to the kernel rendered from
``repro_torch/csrc/flash_attention.cu.j2`` (one instance per head dim,
dtype and ``causal``; B, H, Hk, Sq, Skv and the strides are run-time
arguments, and the kernel tiles q and kv by 64 whatever ``block_q`` and
``block_kv`` say); a CPU tensor goes to `flash_attention_plain`, a
blockwise torch online softmax with the same arithmetic that follows
``block_q``/``block_kv``.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.platform import dtype_name
from repro_torch.core.templates import KernelTemplate
from repro_torch.kernels import _cuda

NEG_INF = -1e30

_TMPL = KernelTemplate.from_file("flash_attention", "flash_attention.cu.j2")
#: head dims the kernel is built for (mma.sync k steps of 16)
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
#: the CUDA kernel's q and kv tile
TILE = 64

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_int])


def instance(head_dim: int, dtype: torch.dtype,
             causal: bool) -> tuple[str, dict]:
    """(name, template constants) of one kernel instance."""
    dt = dtype_name(dtype)
    name = f"flash_attention_d{head_dim}_{dt}_{'causal' if causal else 'full'}"
    return name, dict(head_dim=head_dim, dtype=dt, causal=causal)


def render(head_dim: int, dtype: torch.dtype, causal: bool) -> str:
    name, params = instance(head_dim, dtype, causal)
    return _TMPL.render(name=name, **params)


def _shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, D), k and v (B, Hk, Skv, D): "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Bk, Hk, Skv, Dk = k.shape
    if Bk != B or Dk != D or Hk == 0 or H % Hk:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not pair (H % Hk == 0, same B and D)")
    return B, H, Hk, Sq, Skv, D


def finish(acc, l, dtype):
    """``acc / l`` with ``l == 0`` read as 1 (fully masked rows), cast."""
    return (acc / torch.where(l == 0.0, 1.0, l)).to(dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, block_q: int = 128,
                          block_kv: int = 128, scale: float | None = None,
                          skip_masked_blocks: bool = True):
    """The kernel's plain version: the Pallas kernel's online softmax over
    ``block_kv`` columns at a time, every q block at once; a q block
    skips a kv block strictly above its diagonal (``skip_masked_blocks``)
    by keeping its state."""
    B, H, Hk, Sq, Skv, D = _shapes(q, k, v)
    g = H // Hk
    scale = (D ** -0.5) if scale is None else scale
    pq = -(-Sq // block_q) * block_q
    nk = -(-Skv // block_kv)
    pad = nk * block_kv - Skv
    # q head h = kvh * g + j reads kv head kvh: the GQA index map
    qf = F.pad(q.float(), (0, 0, 0, pq - Sq)).reshape(B, Hk, g, pq, D)
    kf = F.pad(k.float(), (0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, pad))
    dev = q.device
    row = torch.arange(pq, device=dev)[:, None]
    block_last = row // block_q * block_q + block_q - 1
    m = torch.full((B, Hk, g, pq, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hk, g, pq, D), dtype=torch.float32, device=dev)
    for j in range(nk):
        c0 = j * block_kv
        col = c0 + torch.arange(block_kv, device=dev)[None]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf,
                         kf[:, :, c0:c0 + block_kv]) * scale
        if causal:
            s = torch.where(row >= col, s, NEG_INF)
        s = torch.where(col < Skv, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum(
            "bkgqc,bkcd->bkgqd", p.to(v.dtype).float(),
            vp[:, :, c0:c0 + block_kv].float())
        if causal and skip_masked_blocks:
            keep = c0 > block_last          # (pq, 1): the q blocks skipping
            m_cur = torch.where(keep, m, m_cur)
            l_new = torch.where(keep, l, l_new)
            acc_new = torch.where(keep, acc, acc_new)
        m, l, acc = m_cur, l_new, acc_new
    out = finish(acc, l, q.dtype).reshape(B, H, pq, D)
    return out[:, :, :Sq]


def cuda_flash_attention(q, k, v, *, causal: bool = True,
                         scale: float | None = None,
                         skip_masked_blocks: bool = True):
    """The CUDA kernel; raises on what it does not take.  q, k and v may
    be strided views (the model passes its (B, S, H, D) activations with
    the head axis moved) as long as the last axis is contiguous and
    16-byte loads stay aligned; the output is a new contiguous
    (B, H, Sq, D) tensor."""
    B, H, Hk, Sq, Skv, D = _shapes(q, k, v)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"the flash-attention kernel takes CUDA tensors on "
                         f"one device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash-attention kernel takes float32 or "
                        f"bfloat16 q, k and v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    elems = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _cuda.aligned(t, elems):
            raise ValueError(
                f"{name} strides {t.stride()} (or its address) do not allow "
                f"16-byte loads: pass a contiguous tensor")
    if B * H > 65535 or max(Sq, Skv) >= 2 ** 31 - TILE:
        raise ValueError(f"B*H={B * H} or a length exceeds the grid")
    scale = (D ** -0.5) if scale is None else scale
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    name, params = instance(D, q.dtype, causal)
    launch = _cuda.launcher(_TMPL, name, _ARGTYPES, **params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(stream, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, H, Hk, Sq, Skv,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 float(scale), int(bool(skip_masked_blocks)))
    _cuda.launched("flash_attention", name, err)
    return out


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            block_q: int = 128, block_kv: int = 128,
                            scale: float | None = None,
                            skip_masked_blocks: bool = True):
    """q: (B, H, Sq, D); k, v: (B, Hk, Skv, D) with H % Hk == 0 (GQA)."""
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"blocks must be positive: {block_q}, {block_kv}")
    if q.device.type == "cuda":
        return cuda_flash_attention(q, k, v, causal=causal, scale=scale,
                                    skip_masked_blocks=skip_masked_blocks)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                     block_kv=block_kv, scale=scale,
                                     skip_masked_blocks=skip_masked_blocks)
    raise ValueError(f"no flash attention for tensors on {q.device}")
