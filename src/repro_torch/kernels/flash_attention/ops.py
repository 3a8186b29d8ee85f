"""Entry points for flash attention."""

from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_forward

_TUNER = ("the flash-attention autotuner costs TPU VMEM (BlockCost); it is "
          "ported with ROADMAP Queue 1 item 6")


def flash_attention(q, k, v, **kw):
    return flash_attention_forward(q, k, v, **kw)


def flash_attention_tuned(q, k, v, *, causal: bool = True):
    raise NotImplementedError(_TUNER)


def tune_report(q, k, v, causal: bool = True):
    raise NotImplementedError(_TUNER)
