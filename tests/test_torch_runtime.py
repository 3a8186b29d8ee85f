"""The serving runtime of the PyTorch port: `ServingRuntime(backend=
"eager", device="cpu")` against the JAX package's runtime (Pallas in
interpret mode).  K sampler rows of mixed lengths flush as ONE flush of 2
launches; the ragged ``softmax.cdf`` / ``softmax`` / ``rmsnorm`` rows equal
JAX's ``_run_ragged`` (atol=1e-6); the host draw equals a numpy
``searchsorted`` on the same CDF and the same uniform.  Sampled tokens
are not compared with JAX's: torch cannot reproduce threefry draws."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core.cache import DiskCache
from repro_torch import runtime as rtm
from repro_torch.core import dispatch
from repro_torch.runtime import RequestsCache, _draw_cdf

rng = np.random.default_rng(31)
LENS = [1023, 1024, 1025, 700, 33, 1]


@pytest.fixture
def rt():
    r = rtm.ServingRuntime(backend="eager", device="cpu", window=30.0,
                           max_batch=8)
    yield r
    r.close()


@pytest.fixture(scope="module")
def jax_rt(tmp_path_factory):
    r = jrt.ServingRuntime(
        backend="pallas", window=0.25, max_batch=8,
        router=jrt.BackendRouter(),
        manifest=jrt.WarmStartManifest(cache=DiskCache(
            "torch_parity", root=tmp_path_factory.mktemp("manifest"))))
    yield r
    r.close()


def _pad_stack(rows):
    width = max(r.shape[0] for r in rows)
    X = np.zeros((len(rows), width), np.float32)
    for i, r in enumerate(rows):
        X[i, :r.shape[0]] = r
    return X, np.asarray([r.shape[0] for r in rows], np.int32)


def test_sampler_rows_flush_once_in_two_launches(rt):
    rows = [rng.standard_normal(L).astype(np.float32) for L in LENS]
    with dispatch.count_launches() as c:
        futs = [rt.submit_sample(torch.from_numpy(r),
                                 torch.Generator().manual_seed(i), 0.8)
                for i, r in enumerate(rows)]
        rt.flush()
        toks = [f.result(timeout=60) for f in futs]
    assert c.delta == 2 and c.by_backend == {"eager": 2}
    ex = rt.executor.stats()
    assert ex["flushes"] == 1 and ex["requests"] == len(rows)
    (flush_s,) = rt.executor.flush_seconds()
    assert flush_s > 0
    for t, L in zip(toks, LENS):
        assert 0 <= t < L


def test_concurrent_submitters_share_one_flush(rt):
    rows = [rng.standard_normal(L).astype(np.float32) for L in LENS]
    futs = [None] * len(rows)

    def one(i):
        futs[i] = rt.submit_softmax(torch.from_numpy(rows[i]), ragged=True)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(rows))]
    with dispatch.count_launches() as c:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        rt.flush()
        outs = [f.result(timeout=60) for f in futs]
    assert c.delta == 2
    for out, r in zip(outs, rows):
        assert out.shape == r.shape   # true-length prefix, padding stripped
        np.testing.assert_allclose(out.numpy().sum(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("family", ["softmax.cdf", "softmax", "rmsnorm"])
def test_ragged_family_rows_match_jax(rt, jax_rt, family):
    rows = [rng.standard_normal(L).astype(np.float32) for L in LENS]
    X, lens = _pad_stack(rows)
    w = rng.standard_normal(X.shape[1]).astype(np.float32)
    shared = {"w": w, "eps": 1e-6} if family == "rmsnorm" else {}
    ref = np.asarray(jax_rt._run_ragged(
        family, jnp.asarray(X), {**shared, "w": jnp.asarray(w)}
        if shared else {}, lens))
    with dispatch.count_launches() as c:
        got = rt._run_ragged(family, torch.from_numpy(X),
                             {**shared, "w": torch.from_numpy(w)}
                             if shared else {}, torch.from_numpy(lens))
    assert c.delta == 2
    assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("u", [0.0, 1e-7, 0.25, 0.5, 0.999999])
def test_draw_cdf_is_a_host_searchsorted(u):
    p = rng.random(500).astype(np.float32)
    cdf = np.cumsum(p / p.sum()).astype(np.float32)
    cum = cdf.astype(np.float64)
    want = min(int(np.searchsorted(cum, u * cum[-1], side="right")), 499)
    assert _draw_cdf(torch.from_numpy(cdf), u=u) == want


def test_draw_cdf_uses_the_generator():
    cdf = torch.linspace(0.01, 1.0, 100)
    a = _draw_cdf(cdf, torch.Generator().manual_seed(3))
    b = _draw_cdf(cdf, torch.Generator().manual_seed(3))
    assert a == b and 0 <= a < 100


def test_a_failing_post_step_fails_only_its_own_future(rt):
    ex = rt.executor
    rows = [torch.from_numpy(rng.standard_normal(64).astype(np.float32))
            for _ in range(3)]

    def bad(_row):
        raise KeyError("poison")

    futs = [ex.submit("softmax", r, shared={"stable": True},
                      key_extra=(True,), post=bad if i == 1 else None,
                      ragged=True) for i, r in enumerate(rows)]
    rt.flush()
    assert futs[0].result(timeout=30).shape == (64,)
    with pytest.raises(KeyError):
        futs[1].result(timeout=30)
    assert futs[2].result(timeout=30).shape == (64,)


def test_runtime_defaults_to_the_card_and_never_falls_back():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rtm.ServingRuntime()
    with pytest.raises(ValueError, match="CUDA tensors"):
        rtm.ServingRuntime(backend="cuda", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        rtm.ServingRuntime(backend="auto", device="cpu")


def test_dense_families_wait_for_the_planner(rt):
    """The dense families run through the planner now (held against the
    JAX package in tests/test_torch_planner.py); the warm-start manifest
    still waits for Queue 1 item 2."""
    fut = rt.submit_softmax(torch.zeros(8))
    rt.flush()
    assert torch.allclose(fut.result(timeout=30), torch.full((8,), 0.125))
    assert torch.allclose(rt.softmax(torch.zeros(2, 8)),
                          torch.full((2, 8), 0.125))
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        rt.warmup()


# ------------------------------------------------------- RequestsCache
def test_kvcache_admit_release_cycle():
    kv = RequestsCache(2)
    s0 = kv.admit("a", 5)
    s1 = kv.admit("b", 9)
    assert {s0, s1} == {0, 1}
    with pytest.raises(rtm.FleetOverloadError):
        kv.admit("c", 3)
    assert kv.stats()["shed"] == 1
    assert kv.release("a") == s0
    assert kv.admit("c", 3) == s0
    st = kv.stats()
    assert st["admitted"] == 3 and st["released"] == 1 and st["live"] == 2


def test_kvcache_deadline_eviction():
    t = [100.0]
    kv = RequestsCache(2, clock=lambda: t[0])
    kv.admit("a", 4, deadline=5.0)
    kv.admit("b", 4)
    assert kv.expired() == []
    t[0] = 106.0
    assert kv.expired() == ["a"]
    kv.evict("a", expired=True)
    st = kv.stats()
    assert st["evicted"] == 1 and st["expired"] == 1
    with pytest.raises(KeyError):
        kv.release("a")
