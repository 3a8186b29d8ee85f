"""Model configuration schema — the port's own copy of the JAX package's
``configs/base.py`` ``ModelConfig`` (stdlib only, so it is copied, not
imported: the port imports nothing of the JAX package)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MLP / MoE ---------------------------------------------------
    mlp_type: str = "swiglu"         # swiglu | gelu
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_every: int = 1               # MoE on layers where (l % moe_every == moe_offset)
    moe_offset: int = 0
    dense_residual_ffn: bool = False # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- positions / attention ---------------------------------------
    pos_type: str = "rope"           # rope | mrope | learned | none
    rope_theta: float = 1e4
    mrope_sections: tuple = (16, 24, 24)  # qwen2-vl half-dim sections (t,h,w)
    learned_pos_len: int = 32768

    # --- ssm / hybrid --------------------------------------------------
    ssm_type: str = ""               # rwkv6 | mamba ("" = attention everywhere)
    attn_every: int = 0              # hybrid: attention on layers l % attn_every == attn_offset
    attn_offset: int = 0
    ssm_state_dim: int = 16          # mamba N
    ssm_conv_dim: int = 4            # mamba conv width
    ssm_expand: int = 2              # mamba d_inner = expand * d_model
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model/16)
    rwkv_head_dim: int = 64
    rwkv_decay_rank: int = 64

    # --- encoder-decoder ----------------------------------------------
    encoder_layers: int = 0
    encoder_positions: int = 0       # whisper stub frame count

    # --- modality frontends (STUBS: input_specs provides embeddings) ---
    frontend: str = ""               # "" | audio | vision
    vision_tokens: int = 256         # patch embeddings injected at seq head

    # --- numerics / norms ----------------------------------------------
    dtype: str = "bfloat16"
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    use_bias: bool = False
    tie_embeddings: bool = False

    # --- training-time knobs (overridable per run) ----------------------
    remat: str = "full"              # none | dots | full
    scan_chunk: int = 128            # ssm time-chunk (checkpointed)
    attn_q_chunk: int = 1024         # jnp flash chunk sizes
    attn_kv_chunk: int = 1024
    causal_schedule: str = "masked_full"   # masked_full | prefix_unrolled
    loss_chunk: int = 0              # 0 = unchunked cross-entropy
    attention_impl: str = "flash_jnp"      # flash_jnp | naive | pallas
    wkv_impl: str = "scan"                 # scan | pallas (train-time WKV)
    optimizer: str = "adamw"         # adamw | adafactor
    parallelism_profile: str = "tp_fsdp"   # tp_fsdp | dp_fsdp (see sharding/partition.py)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def mixer_for_layer(self, layer: int) -> str:
        """'attn' | 'rwkv6' | 'mamba' for decoder layer `layer`."""
        if not self.ssm_type:
            return "attn"
        if self.attn_every and layer % self.attn_every == self.attn_offset:
            return "attn"
        return self.ssm_type

    def mlp_for_layer(self, layer: int) -> str:
        if self.is_moe and layer % self.moe_every == self.moe_offset:
            return "moe"
        return "dense"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> dict:
        """Analytic parameter counts (total and active per token)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        H, Hk, dh = self.num_heads, self.num_kv_heads, self.dh
        attn = d * H * dh + 2 * d * Hk * dh + H * dh * d
        dense_mlp = (3 if self.mlp_type == "swiglu" else 2) * d * f
        total = V * d + (0 if self.tie_embeddings else V * d)
        active = total
        n_layers = self.num_layers
        for l in range(n_layers):
            mixer = self.mixer_for_layer(l)
            if mixer == "attn":
                mix = attn
            elif mixer == "rwkv6":
                hh = d // self.rwkv_head_dim
                mix = 5 * d * d + 2 * d * self.rwkv_decay_rank + hh * self.rwkv_head_dim + 7 * d
            else:  # mamba
                din = self.ssm_expand * d
                dtr = self.ssm_dt_rank or -(-d // 16)
                mix = d * 2 * din + din * self.ssm_conv_dim + din * (dtr + 2 * self.ssm_state_dim) \
                    + dtr * din + din * self.ssm_state_dim + din + din * d
            total += mix + 2 * d
            active += mix + 2 * d
            if self.mlp_for_layer(l) == "moe":
                total += d * self.num_experts + self.num_experts * dense_mlp
                active += d * self.num_experts + self.num_experts_per_tok * dense_mlp
                if self.dense_residual_ffn:
                    total += dense_mlp
                    active += dense_mlp
            else:
                total += dense_mlp
                active += dense_mlp
        for _ in range(self.encoder_layers):
            total += attn + dense_mlp + 2 * d
            active += attn + dense_mlp + 2 * d
        if self.is_encdec:  # cross attention in every decoder layer
            total += self.num_layers * attn
            active += self.num_layers * attn
        return {"total": total, "active": active}
