"""The rows-form kernel families of the PyTorch port against the JAX
package: `ReductionKernel(axis=-1)` and `ElementwiseKernel(layout="rows")`,
dense and ragged.  The JAX side runs the Pallas backend in interpret
mode (as its own suites run it on the CPU), the port side its ``eager``
backend — the plain version of the port's CUDA kernels.  Same numpy
inputs; values within rtol=1e-5, atol=1e-6 (float32, sums taken in
another order); equal dtypes; equal launch counts.

The CUDA kernels themselves are held against ``eager`` on the card by
the ``cuda``-marked test here (skipped without a card) and by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core.elementwise import ElementwiseKernel as JEK
from repro.core.platform import BroadcastArg as JBA
from repro.core.platform import ScalarArg as JSA
from repro.core.platform import VectorArg as JVA
from repro.core.reduction import ReductionKernel as JRK
from repro_torch.core import dispatch
from repro_torch.core.elementwise import ElementwiseKernel
from repro_torch.core.platform import BroadcastArg, ScalarArg, VectorArg
from repro_torch.core.reduction import ReductionKernel

GEOMS = [(b, n) for b in (1, 7, 32) for n in (1023, 1024, 1025)]
RTOL, ATOL = 1e-5, 1e-6

WAVE = dict(dtype_out=["float32", "float32"], neutral=["-3.4e38", "0"],
            reduce_expr=["fmaxf(a, b)", "a + b"],
            map_expr=["x[i]", "expf(x[i] - _acc0)"])
EPI_OP = "out[i] = (x[i] - r0) * w[i] + s"
CDF_OP = "out[i] = cumsumf(expf(x[i] - r0) / r1)"


def _jax_wave():
    return JRK(WAVE["dtype_out"], WAVE["neutral"], WAVE["reduce_expr"],
               WAVE["map_expr"], "float *x", axis=-1, name="pw",
               backend="pallas")


def _port_wave():
    return ReductionKernel(WAVE["dtype_out"], WAVE["neutral"],
                           WAVE["reduce_expr"], WAVE["map_expr"], "float *x",
                           axis=-1, name="pw", backend="eager")


def _data(b, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n)) * 3).astype(np.float32)
    lens = rng.integers(1, n + 1, size=b).astype(np.int32)
    lens[0] = n
    lens[-1] = 1 if b > 1 else n
    return rng, x, lens


def _check(jax_out, port_out):
    jax_out = jax_out if isinstance(jax_out, tuple) else (jax_out,)
    port_out = port_out if isinstance(port_out, tuple) else (port_out,)
    assert len(jax_out) == len(port_out)
    for j, p in zip(jax_out, port_out):
        j = np.asarray(j)
        assert str(j.dtype) == str(p.dtype).replace("torch.", "")
        assert tuple(j.shape) == tuple(p.shape)
        np.testing.assert_allclose(p.numpy(), j, rtol=RTOL, atol=ATOL)


def _both(jax_call, port_call):
    with jdispatch.count_launches() as jc:
        jo = jax_call()
    with dispatch.count_launches() as pc:
        po = port_call()
    assert jc.delta == pc.delta == 1, (jc.by_backend, pc.by_backend)
    _check(jo, po)


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("b,n", GEOMS)
def test_two_accumulator_wave_matches_jax(b, n, ragged):
    """Row max, then the exp-sum shifted by it (`_acc0` chaining)."""
    _, x, lens = _data(b, n, seed=b * 7 + n)
    rl = lens if ragged else None
    _both(lambda: _jax_wave()(jnp.asarray(x), row_lens=rl),
          lambda: _port_wave()(torch.from_numpy(x),
                               row_lens=None if rl is None
                               else torch.from_numpy(rl)))


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
@pytest.mark.parametrize("b,n", GEOMS)
def test_broadcast_epilogue_matches_jax(b, n, ragged):
    """Row, col and scalar broadcast arguments in one rows epilogue."""
    rng, x, lens = _data(b, n, seed=b * 11 + n)
    r0 = rng.standard_normal(b).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    s = np.float32(0.25)
    jk = JEK([JBA(jnp.float32, "r0", "row"), JBA(jnp.float32, "w", "col"),
              JSA(jnp.float32, "s"), JVA(jnp.float32, "x"),
              JVA(jnp.float32, "out")], EPI_OP, name="pe", layout="rows",
             backend="pallas")
    pk = ElementwiseKernel([BroadcastArg(torch.float32, "r0", "row"),
                            BroadcastArg(torch.float32, "w", "col"),
                            ScalarArg(torch.float32, "s"),
                            VectorArg(torch.float32, "x"),
                            VectorArg(torch.float32, "out")], EPI_OP,
                           name="pe", layout="rows", backend="eager")
    rl = lens if ragged else None
    _both(lambda: jk(jnp.asarray(r0), jnp.asarray(w), s, jnp.asarray(x),
                     jnp.asarray(x), row_lens=rl),
          lambda: pk(torch.from_numpy(r0), torch.from_numpy(w), float(s),
                     torch.from_numpy(x), torch.from_numpy(x),
                     row_lens=None if rl is None else torch.from_numpy(rl)))


@pytest.mark.parametrize("b,n", GEOMS)
def test_ragged_cdf_epilogue_matches_jax(b, n):
    """The sampler epilogue: `cumsumf` row prefix sums, zero past each
    row's length."""
    _, x, lens = _data(b, n, seed=b * 13 + n)
    r0, r1 = (np.array(v) for v in _jax_wave()(jnp.asarray(x),
                                                  row_lens=lens))
    args = [BroadcastArg(torch.float32, "r0", "row"),
            BroadcastArg(torch.float32, "r1", "row"),
            VectorArg(torch.float32, "x"), VectorArg(torch.float32, "out")]
    jk = JEK([JBA(jnp.float32, "r0", "row"), JBA(jnp.float32, "r1", "row"),
              JVA(jnp.float32, "x"), JVA(jnp.float32, "out")], CDF_OP,
             name="pc", layout="rows", backend="pallas")
    pk = ElementwiseKernel(args, CDF_OP, name="pc", layout="rows",
                           backend="eager")
    _both(lambda: jk(jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(x),
                     jnp.asarray(x), row_lens=lens),
          lambda: pk(torch.from_numpy(r0), torch.from_numpy(r1),
                     torch.from_numpy(x), torch.from_numpy(x),
                     row_lens=torch.from_numpy(lens)))


def test_driver_builds_follow_the_jax_buckets():
    """Both packages build one driver per (batch, col) bucket pair: a
    sweep across the same geometries builds the same number."""
    jw, pw = _jax_wave(), _port_wave()
    with jdispatch.count_compiles() as jc, dispatch.count_compiles() as pc:
        for b, n in [(1, 5), (2, 5), (3, 130), (4, 200), (3, 100)]:
            x = np.ones((b, n), np.float32)
            jw(jnp.asarray(x))
            pw(torch.from_numpy(x))
    assert jc.delta == pc.delta == 4


def test_unported_forms_raise():
    with pytest.raises(NotImplementedError, match="Queue 2 item 4"):
        ReductionKernel("float32", "0", "a+b", "x[i]", "float *x")
    with pytest.raises(NotImplementedError, match="Queue 2 item 3"):
        ElementwiseKernel("float *x, float *z", "z[i] = x[i]")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py checks the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_eager_on_the_card(cuda_device):
    """The two CUDA kernels against their plain versions on card tensors."""
    _, x, lens = _data(7, 1025, seed=5)
    X, L = torch.from_numpy(x).to(cuda_device), \
        torch.from_numpy(lens).to(cuda_device)
    wave = _port_wave()
    got = wave(X, backend="cuda", row_lens=L)
    ref = wave(X, backend="eager", row_lens=L)
    assert torch.equal(got[0], ref[0])
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=0)
    epi = ElementwiseKernel([BroadcastArg(torch.float32, "r0", "row"),
                             BroadcastArg(torch.float32, "r1", "row"),
                             VectorArg(torch.float32, "x"),
                             VectorArg(torch.float32, "out")], CDF_OP,
                            name="pc", layout="rows")
    got = epi(*ref, X, X, backend="cuda", row_lens=L)
    torch.testing.assert_close(got, epi(*ref, X, X, backend="eager",
                                        row_lens=L), rtol=0, atol=1e-4)
