"""internlm2-1.8b — InternLM2 1.8B dense GQA model.

[arXiv:2403.17297]  24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1e6,
    parallelism_profile="tp_sp_fsdp",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512, scan_chunk=8, attn_q_chunk=16, attn_kv_chunk=16,
)
