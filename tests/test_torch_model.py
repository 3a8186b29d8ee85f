"""The model and engine of the PyTorch port against the JAX package, on
the ``internlm2-1.8b`` SMOKE config in float32 with naive attention (as
``tests/test_decode.py`` sets it), the JAX weights carried across by
``params_from_jax``: prefill and decode logits within rtol=atol=1e-4
(float32, other summation order), greedy `ContinuousEngine` tokens
identical, and a steady runtime-sampled step of exactly 2 launches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.schema import count_params as jax_count
from repro.models.schema import init_params as jax_init
from repro.serving.engine import ContinuousEngine as JaxEngine
from repro_torch import runtime as rtm
from repro_torch.configs.registry import get_config
from repro_torch.core import dispatch
from repro_torch.models import attention, layers, transformer
from repro_torch.models.schema import (build_schema, count_params,
                                       init_params, params_from_jax)
from repro_torch.serving.engine import ContinuousEngine

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    over = dict(dtype="float32", attention_impl="naive")
    jcfg = jax_config("internlm2-1.8b", smoke=True).replace(**over)
    cfg = get_config("internlm2-1.8b", smoke=True).replace(**over)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, params


def _prompt(rng, cfg, L):
    return rng.integers(1, cfg.vocab_size, size=L).astype(np.int32)


def test_configs_are_copies_of_the_jax_configs():
    for smoke in (False, True):
        assert get_config("internlm2-1.8b", smoke=smoke).__dict__ == \
            jax_config("internlm2-1.8b", smoke=smoke).__dict__


def test_init_params_matches_jax_shapes_and_dtypes(model):
    jcfg, jparams, cfg, _ = model
    ours = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(build_schema(cfg)["decoder"]["slot_0"]) + 3
    for path, leaf in flat_j:
        node = ours
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype)
    assert count_params(ours) == jax_count(jparams)


def test_prefill_and_decode_logits_match_jax(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    jl, jc = jtr.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                         max_len=20)
    tl, tc = transformer.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                                 max_len=20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(3):
        nt = rng.integers(1, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jc = jtr.decode_step(jcfg, jparams, jc, jnp.asarray(nt),
                                 jnp.int32(12 + i))
        tl, tc = transformer.decode_step(cfg, params, tc,
                                         torch.from_numpy(nt), 12 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["slot_0"]["k"].numpy(),
                               np.asarray(jc["slot_0"]["k"]), **TOL)


def test_flash_path_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    want = jattn.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, scale=0.25,
                                     q_chunk=16, kv_chunk=8)
    got = attention.flash_attention_jnp(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, scale=0.25, q_chunk=16, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_and_gelu_mlp_match_jax(model):
    jcfg, _, cfg, _ = model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        **TOL)
    p = {"wi": rng.standard_normal((64, 128)).astype(np.float32) * 0.1,
         "wo_mlp": rng.standard_normal((128, 64)).astype(np.float32) * 0.1}
    h = rng.standard_normal((2, 3, 64)).astype(np.float32)
    gcfg, jgcfg = cfg.replace(mlp_type="gelu"), jcfg.replace(mlp_type="gelu")
    from repro.sharding.partition import NULL_CTX
    want = jlayers.dense_mlp(jgcfg, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(h), NULL_CTX)
    got = layers.dense_mlp(gcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_continuous_engine_greedy_tokens_match_jax(model):
    """5 mixed-length requests through capacity 2: slots recycle
    mid-stream and every request decodes JAX's exact greedy tokens."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(23)
    lens, budgets = [5, 9, 3, 7, 2], [4, 2, 5, 3, 4]
    prompts = [_prompt(rng, cfg, L) for L in lens]
    jeng = JaxEngine(jcfg, jparams, capacity=2, max_len=48)
    eng = ContinuousEngine(cfg, params, capacity=2, max_len=48, device="cpu")
    for p, m in zip(prompts, budgets):
        jeng.submit(p, max_new=m)
        eng.submit(p, max_new=m)
    want = {r.request_id: r.tokens for r in jeng.run()}
    got = {r.request_id: r.tokens for r in eng.run()}
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert eng.stats()["steps"] == jeng.stats()["steps"]
    assert eng.stats()["kv"]["live"] == 0


def test_runtime_step_is_two_launches(model):
    """A steady step (decode + ONE ragged sampler flush) is exactly 2
    generated launches, however many requests are live."""
    _, _, cfg, params = model
    rng = np.random.default_rng(7)
    rt = rtm.ServingRuntime(backend="eager", device="cpu", window=30.0,
                            max_batch=8)
    try:
        eng = ContinuousEngine(cfg, params, capacity=3, max_len=48,
                               runtime=rt, device="cpu")
        for L in (5, 9, 3):
            eng.submit(_prompt(rng, cfg, L), max_new=4)
        eng.step(temperature=0.7)          # admission step
        with dispatch.count_launches() as c:
            eng.step(temperature=0.7)
        assert c.delta == 2 and c.by_backend == {"eager": 2}
        eng.run(temperature=0.7)
        assert len(eng.done) == 3
        assert all(r.tokens.shape == (4,) for r in eng.done)
    finally:
        rt.close()


def _sample_without_runtime(cfg, params, device, monkeypatch):
    """Serve 2 requests at temperature 0.7 with no runtime attached while
    any ``Tensor.cpu()`` call raises: the draw must stay on ``device``."""
    drawn_on = []
    multinomial = torch.multinomial

    def spy(probs, num, *, generator):
        drawn_on.append((probs.device.type, generator.device.type))
        return multinomial(probs, num, generator=generator)

    def no_host_copy(self, *a, **k):
        raise AssertionError("the sampler copied logits to the host")

    rng = np.random.default_rng(11)
    eng = ContinuousEngine(cfg, params, capacity=2, max_len=32, device=device)
    for L in (4, 6):
        eng.submit(_prompt(rng, cfg, L), max_new=3)
    monkeypatch.setattr(torch, "multinomial", spy)
    monkeypatch.setattr(torch.Tensor, "cpu", no_host_copy)
    eng.run(temperature=0.7)
    monkeypatch.undo()
    assert [r.tokens.shape for r in eng.done] == [(3,), (3,)]
    assert all(0 <= t < cfg.vocab_size for r in eng.done for t in r.tokens)
    assert drawn_on and set(drawn_on) == {(device, device)}


def test_sampling_without_runtime_stays_on_the_device(model, monkeypatch):
    _, _, cfg, params = model
    _sample_without_runtime(cfg, params, "cpu", monkeypatch)


@pytest.mark.cuda
def test_card_engine_without_runtime_samples_on_the_card(model, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, cfg, params = model

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}

    _sample_without_runtime(cfg, to_card(params), "cuda", monkeypatch)


def test_engine_defaults_to_the_card(model):
    _, _, cfg, params = model
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params lie on"):
            ContinuousEngine(cfg, params)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ContinuousEngine(cfg, params)


def test_unported_model_paths_raise(model):
    _, _, cfg, _ = model
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        build_schema(cfg.replace(num_experts=4, num_experts_per_tok=2))
