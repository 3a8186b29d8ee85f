"""Serving with ``attention_impl="pallas"``: the port against the JAX package.

The ``internlm2-1.8b`` SMOKE config in float32 with prefill through the
flash-attention kernel in both packages (the JAX package's in interpret
mode, the port's plain version on the CPU), with the same weights
(`params_from_jax`): prefill and decode logits, greedy tokens from the
continuous-batching engine, and greedy tokens, ids and lengths from the
static-batch `Engine` + `RequestQueue` on a block of mixed prompt
lengths (left-padded, so the prefill's kv length is the block width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import transformer as jtr
from repro.models.schema import init_params as jax_init
from repro.serving import engine as jeng
from repro_torch import runtime as rtm
from repro_torch.configs.registry import get_config
from repro_torch.core import dispatch
from repro_torch.models import transformer
from repro_torch.models.schema import params_from_jax
from repro_torch.serving import (ContinuousEngine, Engine, GenerationResult,
                                 RequestQueue)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    over = dict(dtype="float32", attention_impl="pallas")
    jcfg = jax_config("internlm2-1.8b", smoke=True).replace(**over)
    cfg = get_config("internlm2-1.8b", smoke=True).replace(**over)
    jparams = jax_init(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, params


def _prompts(seed, cfg, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=L).astype(np.int32)
            for L in lens]


def test_prefill_and_decode_logits_match_jax(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 37)).astype(np.int32)
    jl, jc = jtr.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                         max_len=44)
    tl, tc = transformer.prefill(
        cfg, params, {"tokens": torch.from_numpy(toks)}, max_len=44)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(3):
        nt = rng.integers(1, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jc = jtr.decode_step(jcfg, jparams, jc, jnp.asarray(nt),
                                 jnp.int32(37 + i))
        tl, tc = transformer.decode_step(cfg, params, tc,
                                         torch.from_numpy(nt), 37 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_continuous_engine_greedy_tokens_match_jax(model):
    jcfg, jparams, cfg, params = model
    prompts = _prompts(23, cfg, [5, 9, 3, 7])
    budgets = [4, 2, 5, 3]
    je = jeng.ContinuousEngine(jcfg, jparams, capacity=2, max_len=40)
    te = ContinuousEngine(cfg, params, capacity=2, max_len=40, device="cpu")
    for p, m in zip(prompts, budgets):
        je.submit(p, max_new=m)
        te.submit(p, max_new=m)
    want = {r.request_id: r.tokens for r in je.run()}
    got = {r.request_id: r.tokens for r in te.run()}
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_static_engine_and_request_queue_match_jax(model):
    """Blocks of 3 over 5 mixed-length prompts: the first block is
    left-padded to 11, the second to 6; tokens, ids, prompt lengths and
    padded lengths equal the JAX package's."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts(29, cfg, [11, 4, 7, 6, 2])
    jq, tq = jeng.RequestQueue(), RequestQueue()
    for i, p in enumerate(prompts):
        assert jq.submit(p, request_id=10 + i) == \
            tq.submit(p, request_id=10 + i)
    want = jq.run(jeng.Engine(jcfg, jparams, max_len=24), batch_size=3,
                  steps=5)
    got = tq.run(Engine(cfg, params, max_len=24, device="cpu"), batch_size=3,
                 steps=5)
    assert [r.request_id for r in got] == [r.request_id for r in want]
    assert [r.padded_len for r in got] == [11, 11, 11, 6, 6]
    for g, w in zip(got, want):
        assert (g.prompt_len, g.padded_len) == (w.prompt_len, w.padded_len)
        np.testing.assert_array_equal(g.prompt, w.prompt)
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(g.sequence, w.sequence)
    assert tq.result_for(13).prompt_len == 6 and tq.result_for(99) is None


def test_engine_generate_greedy_matches_jax(model):
    jcfg, jparams, cfg, params = model
    toks = np.stack(_prompts(31, cfg, [9, 9]))
    want = jeng.Engine(jcfg, jparams, max_len=16).generate(toks, 6)
    got = Engine(cfg, params, max_len=16, device="cpu").generate(toks, 6)
    assert isinstance(got, GenerationResult)
    assert (got.steps, got.prefill_len) == (want.steps, want.prefill_len)
    assert got.tokens.shape == (2, 6) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    with pytest.raises(ValueError, match="exceed max_len 16"):
        Engine(cfg, params, max_len=16, device="cpu").generate(toks, 8)


def test_engine_samples_through_the_runtime(model):
    """With a runtime at temperature > 0, every decode step's draw is one
    dense softmax schedule: 2 launches."""
    _, _, cfg, params = model
    rt = rtm.ServingRuntime(backend="eager", device="cpu")
    eng = Engine(cfg, params, max_len=16, runtime=rt, device="cpu")
    toks = np.stack(_prompts(37, cfg, [6, 6, 6]))
    with dispatch.count_launches() as c:
        res = eng.generate(toks, 4, temperature=0.8, seed=5)
    assert c.by_backend == {"eager": 2 * 4}
    assert res.tokens.shape == (3, 4)
    assert ((0 <= res.tokens) & (res.tokens < cfg.vocab_size)).all()
    again = eng.generate(toks, 4, temperature=0.8, seed=5)
    np.testing.assert_array_equal(again.tokens, res.tokens)


def test_engine_without_runtime_samples_on_the_device(model, monkeypatch):
    _, _, cfg, params = model
    drawn_on = []
    multinomial = torch.multinomial

    def spy(probs, num, *, generator):
        drawn_on.append((probs.device.type, generator.device.type))
        return multinomial(probs, num, generator=generator)

    monkeypatch.setattr(torch, "multinomial", spy)
    res = Engine(cfg, params, max_len=16, device="cpu").generate(
        np.stack(_prompts(41, cfg, [5, 5])), 3, temperature=0.7, seed=2)
    assert res.tokens.shape == (2, 3)
    assert drawn_on and set(drawn_on) == {("cpu", "cpu")}


def test_engine_defaults_to_the_card(model):
    _, _, cfg, params = model
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params lie on"):
            Engine(cfg, params)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(cfg, params)


@pytest.mark.cuda
def test_card_prefill_runs_the_kernel_once_per_layer(model):
    """On the card: a pallas prefill launches the flash-attention kernel
    once per layer and agrees with the CPU's plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, cfg, params = model

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}

    toks = torch.from_numpy(np.stack(_prompts(43, cfg, [70, 70, 70])))
    want, _ = transformer.prefill(cfg, params, {"tokens": toks}, max_len=80)
    with dispatch.count_launches() as c:
        got, _ = transformer.prefill(cfg, to_card(params),
                                     {"tokens": toks.cuda()}, max_len=80)
        torch.cuda.synchronize()
    assert c.by_kernel == {"flash_attention": cfg.num_layers}
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3)
