"""The fusion planner of the PyTorch port against the JAX package:
`RTCGArray`, `plan` / `plan_many` (reduction waves, same-wave ``_acc``
chaining, CSE, broadcasting leaves, column reductions), the dense
`ServingRuntime` families and `layers.fused_softmax` / `rtcg_rmsnorm`.

Same numpy inputs (from a seed) on both sides; the JAX package plans on
its ``xla`` backend (``REPRO_BACKEND=xla`` for this module, as its own
suites do) and, for a few small cases, on ``pallas`` in interpret mode;
the port plans on ``eager`` (CPU tensors), the plain version of its CUDA
kernels.  Every case compares values, dtypes, shapes and the number of
generated launches.  Tolerances: pointwise float32 rtol 1e-6, atol
1e-6; anything that passed through a float32 sum
``|d| <= 1e-5 * sum|terms| + 1e-6`` (for softmax and rmsnorm outputs,
whose terms are O(1), atol 1e-6 plus rtol 1e-5); max/min and int32
exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.array as jga
import repro_torch.core.array as tga
from repro import runtime as jrt
from repro.core import dispatch as jdispatch
from repro.core.cache import DiskCache
from repro.models import layers as jlayers
from repro_torch import runtime as rtm
from repro_torch.core import dispatch
from repro_torch.core.cache import LRUCache
from repro_torch.models import layers as tlayers

rng = np.random.default_rng(19)
BOUNDARY = (1023, 1024, 1025)


@pytest.fixture(scope="module", autouse=True)
def jax_on_xla():
    old = os.environ.get("REPRO_BACKEND")
    os.environ["REPRO_BACKEND"] = "xla"
    yield
    if old is None:
        os.environ.pop("REPRO_BACKEND", None)
    else:
        os.environ["REPRO_BACKEND"] = old


def _put(ga, x):
    return ga.to_gpu(x) if ga is jga else ga.to_gpu(x, device="cpu")


def _val(v):
    if isinstance(v, (jga.RTCGArray, tga.RTCGArray)):
        v = v.value
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _dt(v):
    return str(_val(v).dtype)


def _both(make, launches=None):
    """``make(ga)`` builds and runs the computation with one package's
    array module; both run inside their launch counters."""
    with jdispatch.count_launches() as jc:
        jo = make(jga)
    with dispatch.count_launches() as pc:
        po = make(tga)
    assert jc.delta == pc.delta, (jc.by_backend, pc.by_backend)
    if launches is not None:
        assert pc.delta == launches
    return jo, po


def _check(jo, po, rtol=1e-6, atol=1e-6, exact=False):
    jo = jo if isinstance(jo, (tuple, list)) else (jo,)
    po = po if isinstance(po, (tuple, list)) else (po,)
    assert len(jo) == len(po)
    for j, p in zip(jo, po):
        j, p = _val(j), _val(p)
        assert str(j.dtype) == str(p.dtype), (j.dtype, p.dtype)
        assert j.shape == p.shape, (j.shape, p.shape)
        if exact:
            np.testing.assert_array_equal(p, j)
        else:
            np.testing.assert_allclose(p, j, rtol=rtol, atol=atol)


def _sum_close(jo, po, abs_terms):
    d = np.abs(_val(po).astype(np.float64) - _val(jo).astype(np.float64))
    assert np.all(d <= 1e-5 * np.asarray(abs_terms, np.float64) + 1e-6), \
        float(d.max())


# ------------------------------------------------------------ elementwise
def test_fig3b_and_fused_chain_one_kernel():
    a = rng.standard_normal((4, 4)).astype(np.float32)
    jo, po = _both(lambda ga: (2 * _put(ga, a)).value, launches=1)
    _check(jo, po)
    x, y = (rng.standard_normal(2048).astype(np.float32) for _ in range(2))
    jo, po = _both(lambda ga: (2 * _put(ga, x) + 3 * _put(ga, y)
                               - ga.exp(_put(ga, x))).value, launches=1)
    _check(jo, po)
    assert isinstance(_put(tga, x).get(), np.ndarray)


def test_isomorphic_plans_share_one_generated_kernel():
    x = rng.standard_normal(700).astype(np.float32)
    X = _put(tga, x)
    (2 * X + 3 * X.exp()).value
    n0 = len(tga._kernel_cache)
    (5 * X + 7 * X.exp()).value     # same structure, new scalars
    assert len(tga._kernel_cache) == n0
    p = tga.plan((2 * X + 1)._expr, reduce_expr="a+b", neutral="0")
    p2 = tga.plan((5 * X + 9)._expr, reduce_expr="a+b", neutral="0")
    p3 = tga.plan((5 * X + 9)._expr, reduce_expr="a+b", neutral="100")
    assert p.kernel_launches == 1 and len(p.scalars) == 2
    assert p2.key == p.key and p3.key != p.key
    assert p.kernel() is p2.kernel()


# ------------------------------------------------------ flat map-reduce
@pytest.mark.parametrize("n", BOUNDARY)
def test_fused_mapreduce_one_launch_unfused_two(n):
    x, y = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    terms = np.abs(2 * x + 3 * y - np.exp(x)).sum()
    for fuse, launches in ((True, 1), (False, 2)):
        jo, po = _both(lambda ga: (2 * _put(ga, x) + 3 * _put(ga, y)
                                   - ga.exp(_put(ga, x))).sum(fuse=fuse).value,
                       launches=launches)
        assert _dt(jo) == _dt(po) and _val(po).shape == ()
        _sum_close(jo, po, terms)


def test_max_min_dot_mean_match_jax():
    x, y = (rng.standard_normal(2050).astype(np.float32) for _ in range(2))
    jo, po = _both(lambda ga: ((_put(ga, x) * _put(ga, x)).max().value,
                               (_put(ga, x) + _put(ga, y)).min().value),
                   launches=2)
    _check(jo, po, exact=True)
    jo, po = _both(lambda ga: (_put(ga, x).dot(_put(ga, y)).value,
                               (2 * _put(ga, x)).mean().value), launches=2)
    _sum_close(jo[0], po[0], np.abs(x * y).sum())
    _sum_close(jo[1], po[1], np.abs(2 * x).mean())


@pytest.mark.parametrize("n", BOUNDARY)
def test_flat_softmax_schedules_match_jax(n):
    x = (rng.standard_normal(n) * 8).astype(np.float32)
    for stable, launches in ((False, 2), (True, 3)):
        jo, po = _both(lambda ga: ga.softmax(_put(ga, x), stable=stable).value,
                       launches=launches)
        _check(jo, po, rtol=1e-5)


def test_centering_variance_and_normalize_schedules():
    x = rng.standard_normal(2500).astype(np.float32)
    jo, po = _both(lambda ga: (_put(ga, x) - _put(ga, x).mean()).value,
                   launches=2)
    _check(jo, po, rtol=1e-5, atol=1e-5)

    def var(ga):
        X = _put(ga, x)
        return ((X - X.mean()) ** 2).mean().value

    jo, po = _both(var, launches=2)
    _sum_close(jo, po, ((x - x.mean()) ** 2).sum() / x.size)

    def norm(ga):
        X = _put(ga, x)
        return ((X - X.mean()) / (((X - X.mean()) ** 2).mean()
                                  + 1e-6).sqrt()).value

    jo, po = _both(norm)
    _check(jo, po, rtol=1e-5, atol=1e-5)


def test_flat_softmax_matches_pallas_interpret():
    x = rng.standard_normal(4000).astype(np.float32)
    with jdispatch.count_launches() as jc:
        jo = jga.softmax(jga.to_gpu(x), stable=True).evaluate(
            backend="pallas").value
    with dispatch.count_launches() as pc:
        po = tga.softmax(_put(tga, x), stable=True).value
    assert jc.delta == pc.delta == 3
    _check(jo, po, rtol=1e-5)


# ------------------------------------------------------------ plan_many
def test_plan_many_sibling_reductions_one_launch():
    x = rng.standard_normal(3000).astype(np.float32)

    def stats(ga):
        chain = _put(ga, x) * 2 + 1
        sched = ga.plan_many([chain.min(), chain.max(), chain.sum()])
        assert sched.kernel_launches == 1
        return sched.launch()

    jo, po = _both(stats, launches=1)
    _check(jo[:2], po[:2], exact=True)
    _sum_close(jo[2], po[2], np.abs(x * 2 + 1).sum())


def test_plan_many_mixed_roots_and_kernel_sharing():
    x = rng.standard_normal(1500).astype(np.float32)

    def mixed(ga):
        X = _put(ga, x)
        return ga.plan_many([X * 2, X.sum(), X.mean()]).launch()

    jo, po = _both(mixed)
    _check(jo[0], po[0])
    _sum_close(jo[1], po[1], np.abs(x).sum())
    _sum_close(jo[2], po[2], np.abs(x).mean())
    X, Y = _put(tga, x), _put(tga, x[::-1].copy())
    s1 = tga.plan_many([(X * 2).min(), (X * 2).max()])
    s2 = tga.plan_many([(Y * 5).min(), (Y * 5).max()])
    assert s1.steps[0].key == s2.steps[0].key
    assert s1.steps[0].kernel() is s2.steps[0].kernel()


# --------------------------------------------------- dtype faithfulness
def test_int32_plans_exact_and_neutrals():
    xi = rng.integers(-1000, 1000, 4000).astype(np.int32)
    jo, po = _both(lambda ga: ((_put(ga, xi) * 3 + 7).sum().value,
                               (-_put(ga, xi)).min().value,
                               _put(ga, -np.abs(xi) - 1).max().value),
                   launches=3)
    _check(jo, po, exact=True)
    for kind in ("max", "min", "sum"):
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.int32, torch.int32)):
            assert tga._neutral_for(kind, tdt) == jga._neutral_for(kind, jdt)


def test_mixed_dtype_promotion_and_rpow():
    xi = (np.arange(1000, dtype=np.int32) + 16_777_200)
    xf = rng.standard_normal(1000).astype(np.float32)
    jo, po = _both(lambda ga: ((_put(ga, xi) * 0.5).value,
                               _put(ga, xi).mean().value,
                               *ga.plan_many([_put(ga, xi) + 2,
                                              _put(ga, xf) * 1.5]).launch()))
    _check(jo[0], po[0])
    _check(jo[2], po[2], exact=True)            # int root stays int32
    _check(jo[3], po[3])
    assert _dt(jo[1]) == _dt(po[1]) == "float32"
    xs = rng.integers(0, 5, 1200).astype(np.int32)
    jo, po = _both(lambda ga: ((2 ** _put(ga, xf)).value,
                               (1.5 ** _put(ga, xs)).value))
    _check(jo, po, rtol=1e-6)


def test_fusion_kernel_caches_are_lru(monkeypatch):
    monkeypatch.setattr(tga, "_kernel_cache", LRUCache(maxsize=2))
    X = _put(tga, rng.standard_normal(600).astype(np.float32))
    for v in ((X * 2), (X + 2), (X - 2), (X / 2)):
        v.value
    assert len(tga._kernel_cache) <= 2 and tga._kernel_cache.evictions >= 2
    assert tga._kernel_cache.maxsize == 2 and tga._FUSION_CACHE_SIZE == 128


# ------------------------------------------------------- segmented rows
@pytest.mark.parametrize("B", (1, 7))
@pytest.mark.parametrize("n", BOUNDARY)
def test_batched_softmax_two_launches_both_axes(B, n):
    x = (rng.standard_normal((B, n)) * 4).astype(np.float32)
    for stable in (False, True):
        for axis in (-1, 0):
            jo, po = _both(lambda ga: ga.softmax(_put(ga, x), stable=stable,
                                                 axis=axis).value, launches=2)
            _check(jo, po, rtol=1e-5)


def test_row_and_column_reductions_shapes_and_values():
    x = rng.standard_normal((9, 257)).astype(np.float32)
    for axis, shape in ((-1, (9,)), (0, (257,)), (-2, (257,))):
        jo, po = _both(lambda ga: (_put(ga, x).sum(axis=axis).value,
                                   _put(ga, x).max(axis=axis).value,
                                   _put(ga, x).mean(axis=axis).value),
                       launches=3)
        assert _val(po[0]).shape == shape
        _check(jo[1], po[1], exact=True)
        red = -1 if axis == -1 else 0
        _sum_close(jo[0], po[0], np.abs(x).sum(red))
        _sum_close(jo[2], po[2], np.abs(x).mean(red))
    xi = rng.integers(-1000, 1000, (7, 1025)).astype(np.int32)
    jo, po = _both(lambda ga: (_put(ga, xi).sum(axis=-1).value,
                               _put(ga, xi).min(axis=0).value), launches=2)
    _check(jo, po, exact=True)


def test_stable_softmax_single_wave_and_cse():
    x = rng.standard_normal((4, 600)).astype(np.float32)
    X = _put(tga, x)
    sched = tga.plan_many([tga.softmax(X, stable=True)])
    assert len(sched.steps) == 1 and len(sched.steps[0].nodes) == 2
    assert any("_acc0" in s for s in sched.steps[0].snippet)
    chain = X * 2 + 1
    wave = tga.plan_many([chain.min(axis=-1), chain.max(axis=-1),
                          chain.sum(axis=-1)]).steps[0]
    assert len(wave.prelude) == 1 and wave.snippet == ["_t0"] * 3
    epi = tga.plan_many([X.exp() * 2, X.exp() + 1]).epilogues[0]
    assert len(epi.prelude) == 1 and "expf" in epi.prelude[0]
    jsched = jga.plan_many([jga.softmax(jga.to_gpu(x), stable=True)])
    assert len(jsched.steps) == len(sched.steps)


def test_broadcast_leaves_and_mixed_axes():
    B, N = 6, 400
    x = rng.standard_normal((B, N)).astype(np.float32)
    w = rng.standard_normal(N).astype(np.float32)
    c = rng.standard_normal((B, 1)).astype(np.float32)
    one = np.asarray([2.5], np.float32)
    jo, po = _both(lambda ga: (_put(ga, x) * _put(ga, w) + _put(ga, c)
                               - _put(ga, one)).value, launches=1)
    _check(jo, po)
    p = tga.plan((_put(tga, x) * _put(tga, w))._expr)
    assert p.axis == -1 and p.geometry == (B, N)
    for shape, kind in (((6, 400), "full"), ((6, 1), "row"), ((400,), "col"),
                        ((1, 400), "col"), ((1,), "scalar")):
        assert tga._leaf_kind(np.zeros(shape), 6, 400) == kind
    jo, po = _both(lambda ga: ga.plan_many([_put(ga, x).sum(axis=-1),
                                            _put(ga, x).sum(axis=0)]).launch(),
                   launches=2)
    _sum_close(jo[0], po[0], np.abs(x).sum(-1))
    _sum_close(jo[1], po[1], np.abs(x).sum(0))
    jo, po = _both(lambda ga: (_put(ga, x) - _put(ga, x).mean(axis=0)).value,
                   launches=2)
    _check(jo, po, rtol=1e-5, atol=1e-5)


def test_segmented_driver_reuse_within_a_bucket_pair():
    warm = _put(tga, rng.standard_normal((8, 900)).astype(np.float32))
    warm.tanh().sum(axis=-1).value
    warm.sum(axis=0).value
    with dispatch.count_compiles() as cc:
        for B, N in ((8, 899), (7, 950), (5, 1000), (8, 1024)):
            X = _put(tga, rng.standard_normal((B, N)).astype(np.float32))
            X.tanh().sum(axis=-1).value
            X.sum(axis=0).value
    assert cc.delta == 0


# ------------------------------------------------ dense runtime families
@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    port = rtm.ServingRuntime(backend="eager", device="cpu", window=30.0,
                              max_batch=8)
    ref = jrt.ServingRuntime(
        backend="xla", window=30.0, max_batch=8, router=jrt.BackendRouter(),
        manifest=jrt.WarmStartManifest(cache=DiskCache(
            "torch_planner", root=tmp_path_factory.mktemp("manifest"))))
    yield port, ref
    port.close()
    ref.close()


def test_runtime_softmax_rmsnorm_match_jax(runtimes):
    port, ref = runtimes
    x = (rng.standard_normal((2, 3, 257)) * 3).astype(np.float32)
    w = rng.standard_normal(257).astype(np.float32)
    calls = [
        (lambda r, a: r.softmax(a(x)), 2),
        (lambda r, a: r.softmax(a(x[0]), stable=False, axis=0), 2),
        (lambda r, a: r.softmax(a(x[0, 0])), 2),
        (lambda r, a: r.rmsnorm(a(x), a(w), eps=1e-5), 2),
    ]
    for call, launches in calls:
        with jdispatch.count_launches() as jc:
            jo = call(ref, jnp.asarray)
        with dispatch.count_launches() as pc:
            po = call(port, torch.from_numpy)
        assert jc.delta == pc.delta == launches
        _check(jo, po, rtol=1e-5)


def test_runtime_sample_draws_from_the_softmax(runtimes):
    port, _ = runtimes
    logits = np.full((3, 50), -30.0, np.float32)
    logits[[0, 1, 2], [7, 21, 49]] = 30.0
    with dispatch.count_launches() as pc:
        toks = port.sample(torch.from_numpy(logits),
                           torch.Generator().manual_seed(0), temperature=0.8)
    assert pc.delta == 2
    assert toks.dtype == torch.int32 and toks.tolist() == [7, 21, 49]
    assert port.sample(torch.from_numpy(logits), None, 0.0).tolist() == \
        [7, 21, 49]


def test_dense_submissions_coalesce_like_jax(runtimes):
    port, ref = runtimes
    rows = [rng.standard_normal(300).astype(np.float32) for _ in range(5)]
    w = rng.standard_normal(300).astype(np.float32)
    for family in ("softmax", "rmsnorm"):
        def go(r, a, wv):
            if family == "softmax":
                futs = [r.submit_softmax(a(v)) for v in rows]
            else:
                futs = [r.submit_rmsnorm(a(v), wv) for v in rows]
            r.flush()
            return [f.result(timeout=60) for f in futs]

        with jdispatch.count_launches() as jc:
            jo = go(ref, jnp.asarray, jnp.asarray(w))
        with dispatch.count_launches() as pc:
            po = go(port, torch.from_numpy, torch.from_numpy(w))
        assert jc.delta == pc.delta == 2     # 5 requests, one flush
        _check(jo, po, rtol=1e-5)


def test_layers_fused_softmax_and_rtcg_rmsnorm_match_jax():
    x = (rng.standard_normal((2, 4, 512)) * 6).astype(np.float32)
    w = rng.standard_normal(512).astype(np.float32)
    jo, po = _both(lambda ga: (jlayers if ga is jga else tlayers).fused_softmax(
        (jnp.asarray if ga is jga else torch.from_numpy)(x)), launches=2)
    _check(jo, po, rtol=1e-5)
    a = (lambda v: jnp.asarray(v)), (lambda v: torch.from_numpy(v))
    jo, po = _both(lambda ga: (jlayers if ga is jga else tlayers).rtcg_rmsnorm(
        a[ga is tga](x), a[ga is tga](w), eps=1e-6), launches=2)
    _check(jo, po, rtol=1e-5)


# ----------------------------------------------- what is not ported yet
def test_auto_ladder_and_autotune_raise_naming_their_queue_items():
    X = _put(tga, rng.standard_normal(64).astype(np.float32))
    expr = (X * 2).sum()
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        expr.evaluate(backend="auto")
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        expr.evaluate(family="softmax")          # the ladder's breaker cell
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        tlayers.fused_softmax(torch.ones(2, 4), backend="auto")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tga.autotune(expr)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tga.plan_many([expr]).autotune()


def test_card_is_the_default_and_cuda_never_falls_back():
    x = rng.standard_normal((3, 8)).astype(np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tga.to_gpu(x)
    X = _put(tga, x)
    assert X.device.type == "cpu"
    assert tga.RTCGArray(torch.from_numpy(x)).device.type == "cpu"
    for expr in (X * 2, X.sum(), tga.softmax(X, axis=0)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            expr.evaluate(backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlayers.rtcg_rmsnorm(torch.from_numpy(x), torch.ones(8),
                             backend="cuda")
