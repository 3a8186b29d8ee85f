"""Parameter schema: shapes and initialization of the port's models.

The port of the JAX package's ``models/schema.py`` for the decoder it
serves (attention mixer + dense MLP).  The decoder is a repeating
*period* of layer slots; per-slot parameters are stacked along a leading
``num_periods`` axis, exactly as the JAX package stacks them for
``lax.scan``.  The port **keeps** that stacked layout and indexes it per
layer (``p[name][l]``) instead of unstacking it into per-layer modules,
so `params_from_jax` is a leaf-by-leaf copy and the KV cache keeps the
JAX layout ``(P, B, max_len, Hk, dh)``.  Parameters are a plain nested
dict of tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.platform import canonical_dtype


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"        # normal | zeros | ones
    scale: float = 0.02
    dtype: str = ""             # "" -> cfg.dtype

    def with_prefix(self, n: int) -> "ParamDef":
        return ParamDef((n,) + self.shape, self.init, self.scale, self.dtype)


def _attn_defs(cfg: ModelConfig) -> dict:
    d, H, Hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    out = {
        "wq": ParamDef((d, H * dh)),
        "wk": ParamDef((d, Hk * dh)),
        "wv": ParamDef((d, Hk * dh)),
        "wo": ParamDef((H * dh, d)),
    }
    if cfg.use_bias:
        out.update({
            "bq": ParamDef((H * dh,), "zeros"),
            "bk": ParamDef((Hk * dh,), "zeros"),
            "bv": ParamDef((Hk * dh,), "zeros"),
            "bo": ParamDef((d,), "zeros"),
        })
    return out


def _norm_defs(cfg: ModelConfig, name: str) -> dict:
    out = {name: ParamDef((cfg.d_model,), "ones", dtype="float32")}
    if cfg.norm_type == "layernorm":
        out[name + "_b"] = ParamDef((cfg.d_model,), "zeros", dtype="float32")
    return out


def _dense_mlp_defs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"w1": ParamDef((d, f)), "w3": ParamDef((d, f)),
                "w2": ParamDef((f, d))}
    out = {"wi": ParamDef((d, f)), "wo_mlp": ParamDef((f, d))}
    if cfg.use_bias:
        out["bi"] = ParamDef((f,), "zeros")
        out["bo_mlp"] = ParamDef((d,), "zeros")
    return out


def decoder_period(cfg: ModelConfig) -> int:
    period = 1
    if cfg.ssm_type and cfg.attn_every:
        period = np.lcm(period, cfg.attn_every)
    if cfg.is_moe and cfg.moe_every > 1:
        period = np.lcm(period, cfg.moe_every)
    return int(period)


def slot_plan(cfg: ModelConfig) -> list[tuple[str, str]]:
    """[(mixer, mlp)] for each slot in one period."""
    return [(cfg.mixer_for_layer(s), cfg.mlp_for_layer(s))
            for s in range(decoder_period(cfg))]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encdec or cfg.pos_type not in ("rope", "none") or any(
            plan != ("attn", "dense") for plan in slot_plan(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: this slice ports dense attention decoders; "
            "the rest of the model zoo is ROADMAP Queue 1 item 6")


def build_schema(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    schema: dict = {"embedding": ParamDef((V, d))}
    num_periods = cfg.num_layers // decoder_period(cfg)
    dec: dict = {}
    for s, _ in enumerate(slot_plan(cfg)):
        slot: dict = {}
        slot.update(_norm_defs(cfg, "norm1"))
        slot.update(_attn_defs(cfg))
        slot.update(_norm_defs(cfg, "norm2"))
        slot.update(_dense_mlp_defs(cfg))
        dec[f"slot_{s}"] = {k: v.with_prefix(num_periods)
                            for k, v in slot.items()}
    schema["decoder"] = dec
    schema.update(_norm_defs(cfg, "final_norm"))
    if not cfg.tie_embeddings:
        schema["lm_head"] = ParamDef((V, d))
    return schema


def _leaf_paths(tree: dict, prefix=()) -> list[tuple[tuple, object]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_leaf_paths(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _set_path(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get_path(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters with the JAX package's shapes, scales and
    dtypes: ``normal`` leaves draw N(0, 1) in float32 from ``generator``
    (which must live on ``device``), scale, then cast."""
    device = torch.device(device) if device is not None else generator.device
    params: dict = {}
    for path, pd in _leaf_paths(build_schema(cfg)):
        dtype = canonical_dtype(pd.dtype or cfg.dtype)
        if pd.init == "zeros":
            val = torch.zeros(pd.shape, dtype=dtype, device=device)
        elif pd.init == "ones":
            val = torch.ones(pd.shape, dtype=dtype, device=device)
        else:
            val = (torch.randn(pd.shape, generator=generator,
                               dtype=torch.float32, device=device)
                   * pd.scale).to(dtype)
        _set_path(params, path, val)
    return params


def params_from_jax(cfg: ModelConfig, tree, device="cpu") -> dict:
    """Carry the JAX package's parameters across: ``tree`` is its params
    pytree with numpy leaves (``jax.tree.map(np.asarray, params)``).
    The stacked ``num_periods`` axis is kept (see the module docstring);
    every leaf is checked against this schema's shape."""
    params: dict = {}
    for path, pd in _leaf_paths(build_schema(cfg)):
        arr = np.asarray(_get_path(tree, path))
        if tuple(arr.shape) != tuple(pd.shape):
            raise ValueError(f"param {'/'.join(path)}: shape {arr.shape}, "
                             f"schema {pd.shape}")
        if arr.dtype.name == "bfloat16":   # numpy has no bf16: move bits
            t = torch.from_numpy(arr.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        _set_path(params, path, t.to(device))
    return params


def count_params(params) -> int:
    return sum(int(v.numel()) for _, v in _leaf_paths(params))
