"""The RTCG library path of the PyTorch port against the JAX package:
flat `ElementwiseKernel`, flat (`axis=None`) and column (`axis=0`)
`ReductionKernel`, and the prefix scans.

Same numpy inputs (from a seed) go through the JAX package on the CPU —
its ``xla`` backend for most cases, its ``pallas`` backend in interpret
mode for a few small ones (n <= 4096) — and through the port's ``eager``
backend, the plain version of its CUDA kernels (``chip_smoke.py`` holds
the kernels against it on the card).  Compared: values, dtypes, launch
counts and driver-build counts.  Tolerances:

  * pointwise float32: rtol 1e-6, atol 1e-6;
  * float32 sums and ``+`` scans: ``|d| <= 1e-5 * sum|terms| + 1e-6``
    (the same terms added in another order);
  * ``*`` scans on inputs in [0.9, 1.1]: rtol 1e-4;
  * max/min and every int32 result, wraparound included: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core.elementwise import ElementwiseKernel as JEK
from repro.core.platform import BroadcastArg as JBA
from repro.core.platform import VectorArg as JVA
from repro.core.reduction import ReductionKernel as JRK
from repro.core.scan import ExclusiveScanKernel as JExcl
from repro.core.scan import InclusiveScanKernel as JIncl
from repro_torch.core import dispatch
from repro_torch.core.elementwise import ElementwiseKernel
from repro_torch.core.platform import BroadcastArg, VectorArg
from repro_torch.core.reduction import ReductionKernel
from repro_torch.core.scan import ExclusiveScanKernel, InclusiveScanKernel

SIZES = [1, 127, 128, 129, 4097]
LIN = ("float a, float *x, float b, float *y, float *z",
       "z[i] = a*x[i] + b*y[i]")


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_dtype(j, p):
    assert str(np.asarray(j).dtype) == str(p.dtype).replace("torch.", "")


def _both(jax_call, port_call, launches=1):
    """Run both sides, each inside its package's launch counter."""
    with jdispatch.count_launches() as jc:
        jo = jax_call()
    with dispatch.count_launches() as pc:
        po = port_call()
    assert jc.delta == pc.delta == launches, (jc.by_backend, pc.by_backend)
    return jo, po


def _sum_close(got, want, abs_terms):
    """float32 sums: |d| <= 1e-5 * sum|terms| + 1e-6."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(d <= 1e-5 * np.asarray(abs_terms, np.float64) + 1e-6), \
        float(d.max())


# ------------------------------------------------------ flat elementwise
@pytest.mark.parametrize("n", SIZES)
def test_lin_comb_matches_jax(n):
    """The paper's Fig. 4 kernel: scalars by value, the output template
    aliasing an input (``z`` is ``x``)."""
    rng = np.random.default_rng(n)
    x, y = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    jk, pk = JEK(*LIN, name="lin", backend="xla"), ElementwiseKernel(*LIN,
                                                                     name="lin")
    jo, po = _both(lambda: jk(5.0, jnp.asarray(x), 6.0, jnp.asarray(y),
                              jnp.asarray(x)),
                   lambda: pk(5.0, torch.from_numpy(x), 6.0,
                              torch.from_numpy(y), torch.from_numpy(x)))
    _same_dtype(jo, po)
    np.testing.assert_allclose(_np(po), np.asarray(jo), rtol=1e-6, atol=1e-6)


def test_lin_comb_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    x, y = (rng.standard_normal(4096).astype(np.float32) for _ in range(2))
    jo, po = _both(
        lambda: JEK(*LIN, name="lin", backend="pallas")(
            2.0, jnp.asarray(x), -3.0, jnp.asarray(y), jnp.asarray(x)),
        lambda: ElementwiseKernel(*LIN, name="lin")(
            2.0, torch.from_numpy(x), -3.0, torch.from_numpy(y),
            torch.from_numpy(x)))
    np.testing.assert_allclose(_np(po), np.asarray(jo), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("args,op,dt", [
    ("int *o, int *v", "o[i] = v[i] * 3 + i", np.int32),
    ("unsigned *o, unsigned *v", "o[i] = v[i] * 2 + i", np.uint32),
    ("bool *o, float *v", "o[i] = v[i] > 0.5f", np.float32),
    ("float *o, float *v", "o[i] = v[i] > 0 ? expf(v[i]) : 1.0f / (1.0f + i)",
     np.float32),
])
def test_flat_dtypes_and_global_index_match_jax(args, op, dt):
    """Every dtype the CUDA backend binds, the global index ``i`` and a
    2-D operand, which comes back in its own shape."""
    rng = np.random.default_rng(11)
    v = (rng.integers(0, 1000, (7, 33)) if dt != np.float32
         else rng.standard_normal((7, 33))).astype(dt)
    jo, po = _both(
        lambda: JEK(args, op, name="dt", backend="xla")(jnp.asarray(v),
                                                        jnp.asarray(v)),
        lambda: ElementwiseKernel(args, op, name="dt")(torch.from_numpy(v),
                                                       torch.from_numpy(v)))
    _same_dtype(jo, po)
    assert tuple(po.shape) == (7, 33)
    np.testing.assert_allclose(_np(po).astype(np.float64),
                               np.asarray(jo).astype(np.float64),
                               rtol=1e-6, atol=1e-6)


def test_flat_driver_builds_follow_the_jax_buckets():
    """A 2x size sweep builds the same drivers in both packages."""
    op = ("float *o, float *v", "o[i] = 3*v[i] - 1")
    jk, pk = JEK(*op, name="sweep", backend="xla"), \
        ElementwiseKernel(*op, name="sweep")
    with jdispatch.count_compiles() as jc, dispatch.count_compiles() as pc:
        for n in np.linspace(4096, 8191, 9).astype(int).tolist() + [100]:
            v = np.ones(n, np.float32)
            jk(jnp.asarray(v), jnp.asarray(v))
            pk(torch.from_numpy(v), torch.from_numpy(v))
    assert jc.delta == pc.delta == 3


def test_mismatched_vector_lengths_raise():
    """Bucket padding must never hide a short argument."""
    k = ElementwiseKernel("float *z, float *x, float *y", "z[i] = x[i] + y[i]")
    x, short = torch.ones(1000), torch.ones(400)
    with pytest.raises(ValueError, match="expected 1000"):
        k(x, x, short)
    dot = ReductionKernel(np.float32, "0", "a+b", "x[i]*y[i]",
                          "float *x, float *y")
    with pytest.raises(ValueError, match="'y' has 400"):
        dot(x, short)
    with pytest.raises(ValueError, match="BroadcastArg requires"):
        ElementwiseKernel([BroadcastArg(torch.float32, "r", "row"),
                           VectorArg(torch.float32, "z")], "z[i] = r")


# ------------------------------------------------------- flat reductions
REDUCERS = [  # (neutral, reduce_expr, map_expr, value range)
    ("0", "a+b", "x[i]*y[i]", None),
    ("0", "b+a", "x[i] - y[i]", None),
    ("1", "a*b", "x[i]", (0.999, 1.001)),
    ("-3e38", "fmaxf(a,b)", "x[i] + y[i]", None),
    ("-3e38", "max(a,b)", "x[i]", None),
    ("3e38", "fminf(a,b)", "fabsf(x[i])", None),
    ("3e38", "min(a,b)", "y[i]", None),
]


@pytest.mark.parametrize("n", SIZES + [3001])
@pytest.mark.parametrize("neutral,rexpr,mexpr,rng_", REDUCERS,
                         ids=[r[1] for r in REDUCERS])
def test_flat_reduction_every_reducer_matches_jax(neutral, rexpr, mexpr, rng_,
                                                  n):
    rng = np.random.default_rng(n + len(mexpr))
    if rng_ is None:
        x, y = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    else:
        x, y = (rng.uniform(*rng_, n).astype(np.float32) for _ in range(2))
    args = "float *x, float *y"
    jo, po = _both(
        lambda: JRK(np.float32, neutral, rexpr, mexpr, args, name="r",
                    backend="xla")(jnp.asarray(x), jnp.asarray(y)),
        lambda: ReductionKernel(np.float32, neutral, rexpr, mexpr, args,
                                name="r")(torch.from_numpy(x),
                                          torch.from_numpy(y)))
    _same_dtype(jo, po)
    assert po.shape == ()
    if rexpr in ("a+b", "b+a"):
        terms = x * y if "*" in mexpr else x - y
        _sum_close(_np(po), np.asarray(jo), np.abs(terms).sum())
    elif rexpr == "a*b":
        np.testing.assert_allclose(_np(po), np.asarray(jo), rtol=1e-4)
    else:
        np.testing.assert_array_equal(_np(po), np.asarray(jo))


def test_multi_accumulator_reduction_matches_pallas_interpret():
    """min/max/sum quantization stats in ONE launch, the JAX side in
    Pallas interpret mode."""
    x = np.random.default_rng(5).standard_normal(4000).astype(np.float32)
    spec = ([np.float32] * 3, ["3.4e38", "-3.4e38", "0"],
            ["fminf(a,b)", "fmaxf(a,b)", "a+b"], ["x[i]", "x[i]", "x[i]"],
            "float *x")
    jo, po = _both(lambda: JRK(*spec, name="stats", backend="pallas")(
                       jnp.asarray(x)),
                   lambda: ReductionKernel(*spec, name="stats")(
                       torch.from_numpy(x)))
    assert isinstance(po, tuple) and len(po) == 3
    np.testing.assert_array_equal(_np(po[0]), np.asarray(jo[0]))
    np.testing.assert_array_equal(_np(po[1]), np.asarray(jo[1]))
    _sum_close(_np(po[2]), np.asarray(jo[2]), np.abs(x).sum())


@pytest.mark.parametrize("n", [1, 129, 5000])
def test_int32_reductions_wrap_exactly_like_jax(n):
    """int32 sums wrap around 2**32 in both packages (the CUDA kernel
    accumulates as unsigned int); max/min take iinfo neutrals."""
    x = np.random.default_rng(n).integers(2**30, 2**31 - 1, n).astype(np.int32)
    spec = ([np.int32] * 3, ["0", "-2147483648", "2147483647"],
            ["a+b", "max(a,b)", "min(a,b)"], ["x[i] * 3", "-x[i]", "x[i]"],
            "int *x")
    jo, po = _both(lambda: JRK(*spec, name="ired", backend="xla")(
                       jnp.asarray(x)),
                   lambda: ReductionKernel(*spec, name="ired")(
                       torch.from_numpy(x)))
    for j, p in zip(jo, po):
        _same_dtype(j, p)
        assert int(p) == int(j)
    if n > 1:   # the sum really wrapped
        assert int(po[0]) != int((x.astype(np.int64) * 3).sum())


def test_uint32_reductions_match_jax():
    """uint32 sums wrap mod 2**32; max/min order as unsigned."""
    x = np.random.default_rng(8).integers(2**31, 2**32 - 1, 3000) \
        .astype(np.uint32)
    spec = ([np.uint32] * 3, ["0", "0", "4294967295"],
            ["a+b", "max(a,b)", "min(a,b)"], ["x[i]"] * 3, "unsigned *x")
    jo, po = _both(lambda: JRK(*spec, name="ured", backend="xla")(
                       jnp.asarray(x)),
                   lambda: ReductionKernel(*spec, name="ured")(
                       torch.from_numpy(x)))
    for j, p in zip(jo, po):
        _same_dtype(j, p)
        assert int(p) == int(j)


def test_reduction_driver_builds_follow_the_jax_buckets():
    """One driver serves every n of a bucket (the runtime n masks the
    rest) in both packages."""
    spec = (np.float32, "0", "a+b", "x[i]*y[i]", "float *x, float *y")
    jk, pk = JRK(*spec, name="dotb", backend="xla"), \
        ReductionKernel(*spec, name="dotb")
    with jdispatch.count_compiles() as jc, dispatch.count_compiles() as pc:
        for n in (2049, 2500, 3000, 3500, 4096, 9000):
            v = np.ones(n, np.float32)
            jk(jnp.asarray(v), jnp.asarray(v))
            pk(torch.from_numpy(v), torch.from_numpy(v))
    assert jc.delta == pc.delta == 2


# ------------------------------------------------------ column reductions
@pytest.mark.parametrize("b,n", [(1, 7), (3, 1023), (1023, 3), (7, 1025)])
def test_axis0_two_accumulator_wave_matches_jax(b, n):
    """Column max, then the exp-sum shifted by it (``_acc0``), over the
    IR's transposed domain — the column softmax's wave."""
    x = (np.random.default_rng(b + n).standard_normal((b, n)) * 3) \
        .astype(np.float32)
    spec = (["float32", "float32"], ["-3.4e38", "0"], ["fmaxf(a, b)", "a + b"],
            ["x[i]", "expf(x[i] - _acc0)"], "float *x")
    jo, po = _both(lambda: JRK(*spec, axis=0, name="cw", backend="xla")(
                       jnp.asarray(x)),
                   lambda: ReductionKernel(*spec, axis=0, name="cw")(
                       torch.from_numpy(x)))
    for j, p in zip(jo, po):
        _same_dtype(j, p)
        assert tuple(p.shape) == (n,)
    np.testing.assert_array_equal(_np(po[0]), np.asarray(jo[0]))
    _sum_close(_np(po[1]), np.asarray(jo[1]), np.asarray(jo[1]))


def test_axis0_broadcast_kinds_swap_like_jax():
    """A per-column weight (length N) and a per-row scale (length B) in
    storage orientation: transpose_layout swaps their kinds."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((9, 257)).astype(np.float32)
    w = rng.standard_normal(257).astype(np.float32)
    s = rng.standard_normal(9).astype(np.float32)
    op = (np.float32, "0", "a+b", "x[i] * w[i] + s[i]")
    jargs = [JVA(np.float32, "x"), JBA(np.float32, "w", "col"),
             JBA(np.float32, "s", "row")]
    pargs = [VectorArg(torch.float32, "x"), BroadcastArg(torch.float32, "w", "col"),
             BroadcastArg(torch.float32, "s", "row")]
    jo, po = _both(
        lambda: JRK(*op, jargs, axis=0, name="cb", backend="pallas")(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)),
        lambda: ReductionKernel(*op, pargs, axis=0, name="cb")(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s)))
    _sum_close(_np(po), np.asarray(jo), np.abs(x * w[None] + s[:, None]).sum(0))


def test_axis0_driver_builds_and_no_ragged_form():
    spec = (np.float32, "0", "a+b", "x[i]", "float *x")
    jk, pk = JRK(*spec, axis=0, name="cs", backend="xla"), \
        ReductionKernel(*spec, axis=0, name="cs")
    with jdispatch.count_compiles() as jc, dispatch.count_compiles() as pc:
        for b, n in [(10, 900), (12, 1000), (12, 1100)]:
            v = np.ones((b, n), np.float32)
            jk(jnp.asarray(v))
            pk(torch.from_numpy(v))
    assert jc.delta == pc.delta == 2
    with pytest.raises(ValueError, match="axis=-1 only"):
        ReductionKernel(*spec, axis=0, name="cs_r")(
            torch.ones(3, 4), row_lens=torch.ones(4, dtype=torch.int32))


# ------------------------------------------------------------------ scans
SCAN_OPS = [("a+b", "0"), ("a*b", "1"), ("fmaxf(a,b)", "-3e38"),
            ("fminf(a,b)", "3e38")]


def _scan_input(op, n, seed):
    rng = np.random.default_rng(seed)
    if op == "a*b":
        return rng.uniform(0.9, 1.1, n).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


def _scan_close(op, got, want, x, exclusive):
    if op == "a+b":
        terms = np.cumsum(np.abs(x.astype(np.float64)))
        if exclusive:
            terms = np.concatenate([[0.0], terms[:-1]])
        _sum_close(got, want, terms)
    elif op == "a*b":
        np.testing.assert_allclose(got, want, rtol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 9001])
@pytest.mark.parametrize("exclusive", [False, True], ids=["incl", "excl"])
@pytest.mark.parametrize("op,neutral", SCAN_OPS, ids=[o for o, _ in SCAN_OPS])
def test_scans_match_jax(op, neutral, exclusive, n):
    x = _scan_input(op, n, seed=n)
    if exclusive:
        jk = JExcl(np.float32, op, neutral, name="sc", backend="xla")
        pk = ExclusiveScanKernel(np.float32, op, neutral, name="sc")
    else:
        jk = JIncl(np.float32, op, name="sc", backend="xla")
        pk = InclusiveScanKernel(np.float32, op, name="sc")
    jo, po = _both(lambda: jk(jnp.asarray(x)), lambda: pk(torch.from_numpy(x)))
    _same_dtype(jo, po)
    assert tuple(po.shape) == (n,)
    _scan_close(op, _np(po), np.asarray(jo), x, exclusive)


@pytest.mark.parametrize("op,neutral", [("a+b", "0"), ("a*b", "1")])
def test_scans_match_pallas_interpret_across_blocks(op, neutral):
    """Four 1024-element blocks on the JAX side: its carries between
    the two passes (the ``*`` carry a shifted cumprod)."""
    x = _scan_input(op, 4000, seed=9)
    jo, po = _both(
        lambda: JExcl(np.float32, op, neutral, name="scp", block_n=1024,
                      backend="pallas")(jnp.asarray(x)),
        lambda: ExclusiveScanKernel(np.float32, op, neutral, name="scp",
                                    block_n=1024)(torch.from_numpy(x)))
    _scan_close(op, _np(po), np.asarray(jo), x, exclusive=True)


def test_multiplicative_scan_with_a_zero_block_total():
    """A zero in the first block: no carry divides by a block product."""
    v = np.full(10_000, 1.0001, np.float32)
    v[100] = 0.0
    jo = JIncl(np.float32, "a*b", name="sz", backend="xla")(jnp.asarray(v))
    po = InclusiveScanKernel(np.float32, "a*b", name="sz")(torch.from_numpy(v))
    assert np.isfinite(_np(po)).all()
    np.testing.assert_allclose(_np(po), np.asarray(jo), rtol=1e-4)


def test_int32_scan_wraps_exactly_like_jax():
    x = np.random.default_rng(4).integers(2**29, 2**31 - 1, 9000) \
        .astype(np.int32)
    jo, po = _both(lambda: JIncl(np.int32, "a+b", name="isc", backend="xla")(
                       jnp.asarray(x)),
                   lambda: InclusiveScanKernel(np.int32, "a+b", name="isc")(
                       torch.from_numpy(x)))
    _same_dtype(jo, po)
    np.testing.assert_array_equal(_np(po), np.asarray(jo))


def test_scan_driver_builds_follow_the_jax_buckets():
    jk = JIncl(np.float32, "a+b", name="scb", backend="xla")
    pk = InclusiveScanKernel(np.float32, "a+b", name="scb")
    with jdispatch.count_compiles() as jc, dispatch.count_compiles() as pc:
        for n in (100, 3000, 4096, 5000, 8000):
            v = np.ones(n, np.float32)
            jk(jnp.asarray(v))
            pk(torch.from_numpy(v))
    assert jc.delta == pc.delta == 2
    with pytest.raises(NotImplementedError):
        InclusiveScanKernel(np.float32, "a^b")


# ------------------------------------------------------- no CPU fallback
def test_cuda_backend_raises_on_cpu_tensors():
    """Every new entry point pinned to ``cuda`` refuses a CPU tensor
    instead of running it elsewhere."""
    x = torch.ones(64)
    calls = [
        lambda: ElementwiseKernel(*LIN)(1.0, x, 2.0, x, x, backend="cuda"),
        lambda: ReductionKernel(np.float32, "0", "a+b", "x[i]",
                                "float *x")(x, backend="cuda"),
        lambda: ReductionKernel(np.float32, "0", "a+b", "x[i]", "float *x",
                                axis=0)(x.reshape(8, 8), backend="cuda"),
        lambda: InclusiveScanKernel(np.float32, "a+b")(x, backend="cuda"),
        lambda: ExclusiveScanKernel(np.float32, "a*b", "1",
                                    backend="cuda")(x),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


def test_autotune_and_router_raise_naming_their_queue_items():
    x = torch.ones(64)
    kernels = [(ElementwiseKernel(*LIN), (1.0, x, 2.0, x, x)),
               (ReductionKernel(np.float32, "0", "a+b", "x[i]", "float *x"),
                (x,)),
               (InclusiveScanKernel(np.float32, "a+b"), (x,))]
    for k, args in kernels:
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            k.autotune(*args)
        with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
            k(*args, backend="auto")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py checks the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_library_kernels_match_eager_on_the_card(cuda_device):
    """The three new kernel sources against their plain versions."""
    x = torch.randn(5000, device=cuda_device)
    y = torch.randn(5000, device=cuda_device)
    lin = ElementwiseKernel(*LIN)
    torch.testing.assert_close(lin(2.0, x, 3.0, y, x, backend="cuda"),
                               lin(2.0, x, 3.0, y, x, backend="eager"),
                               rtol=1e-6, atol=1e-6)
    dot = ReductionKernel(np.float32, "0", "a+b", "x[i]*y[i]",
                          "float *x, float *y")
    got, want = dot(x, y, backend="cuda"), dot(x, y, backend="eager")
    assert abs(float(got - want)) <= 1e-5 * float((x * y).abs().sum()) + 1e-6
    for op, neutral in SCAN_OPS[2:]:
        k = ExclusiveScanKernel(np.float32, op, neutral)
        assert torch.equal(k(x, backend="cuda"), k(x, backend="eager"))


@pytest.mark.cuda
def test_flat_reduction_on_two_streams_at_once(cuda_device):
    """One reduction kernel launched on two streams at once: each stream
    has its own last-block ticket, so no grid folds another's partials.
    Integer-valued terms make every sum exact in any order."""
    k = ReductionKernel(np.float32, "0", "a+b", "x[i]", "float *x")
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    xs = [torch.randint(-8, 9, (1 << 24,), generator=gen,
                        device=cuda_device).float() for _ in range(2)]
    want = [x.double().sum() for x in xs]
    k(xs[0], backend="cuda")
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(16):
        for j, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs.append((j, k(xs[j], backend="cuda")))
    torch.cuda.synchronize()
    assert all(float(o) == float(want[j]) for j, o in outs)
    assert float(k(xs[1], backend="cuda")) == float(want[1])


def test_flat_reduction_keeps_one_ticket_per_stream(monkeypatch):
    """The CUDA reduction driver's last-block ticket, with the launch
    replaced: one launch after another on a stream reuses its ticket,
    and another stream gets a ticket of its own."""
    from repro_torch.core.backends import cuda as cb
    from repro_torch.core.cache import LRUCache

    tickets, stream = [], [0]

    def fake_launcher(self, kir, entry, argtypes):
        def launch(*cargs):
            tickets.append((cargs[0], cargs[3]))
            return 0
        return launch

    monkeypatch.setattr(dispatch, "_driver_cache", LRUCache(maxsize=8))
    monkeypatch.setattr(cb.CudaBackend, "_launcher", fake_launcher)
    monkeypatch.setattr(cb.CudaBackend, "_device",
                        staticmethod(lambda kir, device: device))
    monkeypatch.setattr(cb.CudaBackend, "_stream",
                        staticmethod(lambda d: stream[0]))
    monkeypatch.setattr(cb, "_grid", lambda n, kernel, device: 2)
    k = ReductionKernel(np.float32, "0", "a+b", "x[i]", "float *x",
                        name="mt")
    x = torch.ones(64)
    for s in (11, 11, 22, 11, 22):
        stream[0] = s
        k(x, backend="cuda")
    by_stream = {}
    for s, t in tickets:
        by_stream.setdefault(s, set()).add(t)
    assert [s for s, _ in tickets] == [11, 11, 22, 11, 22]
    assert all(len(ts) == 1 for ts in by_stream.values())
    assert by_stream[11] != by_stream[22]


def test_cuda_drivers_marshal_every_argument(monkeypatch):
    """The CUDA drivers' launch arguments on the CPU, with the launch
    itself replaced: every entry point gets as many arguments as its
    ctypes signature declares, a transposed (axis=0) operand passes its
    swapped strides, and each kernel counts one launch."""
    from repro_torch.core.backends import cuda as cb
    from repro_torch.core.cache import LRUCache

    calls = []

    def fake_launcher(self, kir, entry, argtypes):
        def launch(*cargs):
            assert len(cargs) == len(argtypes), (entry, cargs, argtypes)
            calls.append((entry, cargs))
            return 0
        return launch

    monkeypatch.setattr(dispatch, "_driver_cache", LRUCache(maxsize=64))
    monkeypatch.setattr(cb.CudaBackend, "_launcher", fake_launcher)
    monkeypatch.setattr(cb.CudaBackend, "_device",
                        staticmethod(lambda kir, device: device))
    monkeypatch.setattr(cb.CudaBackend, "_stream", staticmethod(lambda d: 0))
    monkeypatch.setattr(cb, "_grid", lambda n, kernel, device: 2)
    x, m = torch.ones(64), torch.ones(8, 16)
    wave = ReductionKernel(["float32", "float32"], ["-3.4e38", "0"],
                           ["fmaxf(a, b)", "a + b"],
                           ["x[i]", "expf(x[i] - _acc0)"], "float *x",
                           axis=0, name="mw")
    with dispatch.count_launches() as c:
        ElementwiseKernel(*LIN, name="ml")(1.0, x, 2.0, x, x, backend="cuda")
        ReductionKernel([np.float32] * 2, ["0", "1"], ["a+b", "a*b"],
                        ["x[i]", "x[i]"], "float *x",
                        name="mr")(x, backend="cuda")
        wave(m, backend="cuda")
        ReductionKernel(np.float32, "0", "a+b", "x[i]", "float *x", axis=-1,
                        name="mrr")(m, backend="cuda",
                                    row_lens=torch.full((8,), 16,
                                                        dtype=torch.int32))
        InclusiveScanKernel(np.float32, "a+b", name="ms")(x, backend="cuda")
    assert [e for e, _ in calls] == [
        "ml_launch", "mr_launch", "mw_launch", "mrr_launch",
        "ms_pass1_launch", "ms_pass2_launch"]
    assert c.by_kernel == {"flat_elementwise": 1, "flat_reduction": 1,
                           "row_reduction": 2, "scan_pass1": 1,
                           "scan_pass2": 1}
    # axis=0 over (8, 16): 16 domain rows of 8, x's strides swapped (1, 16)
    _, cargs = calls[2]
    assert cargs[1:3] == (16, 8) and cargs[5:7] == (1, 16)
    # axis=-1 keeps one (row) stride
    _, cargs = calls[3]
    assert cargs[1:3] == (8, 16) and cargs[5] == 16 and len(cargs) == 7
