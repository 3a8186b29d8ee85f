"""Parity of the port's fused RMSNorm with the JAX package's Pallas kernel.

The same seeded numpy inputs go through ``pallas_rmsnorm`` (interpret
mode on the CPU, as ``tests/test_kernels.py`` runs it) and the port's
`ops.rmsnorm` on CPU tensors (the CUDA kernel's plain version,
`rmsnorm_ref`).  float32 at rtol 1e-4, atol 1e-5 (``test_kernels.py``);
bfloat16 to one bf16 step of the output (the float32 sums differ in
order, so a rounding may flip).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_ref
from repro.kernels.rmsnorm.rmsnorm import pallas_rmsnorm
from repro.models import layers as jlayers
from repro_torch.configs.registry import get_config
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm import rmsnorm as rms
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import layers

F32 = dict(rtol=1e-4, atol=1e-5)


def _arrays(seed, shape, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(n)]


def _within_one_bf16_step(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


@pytest.mark.parametrize("shape", [(64, 256), (3, 17, 512), (1, 1, 128)])
def test_matches_pallas(shape):
    x, _ = _arrays(0, shape)
    w = _arrays(1, shape[-1:], 1)[0]
    want = np.asarray(pallas_rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(
        rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w))), **F32)


@pytest.mark.parametrize("block_rows", [8, 128])
def test_fused_residual(block_rows):
    x, r = _arrays(2, (40, 256))
    w = np.ones(256, np.float32)
    want = pallas_rmsnorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(r),
                          block_rows=block_rows)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(r), block_rows=block_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(64, 256), (3, 17, 512)])
def test_bf16(shape, residual):
    x, r = _arrays(3, shape)
    w = _arrays(4, shape[-1:], 1)[0]
    jx, jr = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, r))
    tx, tr = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, r))
    want = pallas_rmsnorm(jx, jnp.asarray(w), jr if residual else None,
                          eps=1e-5)
    got = ops.rmsnorm(tx, torch.from_numpy(w), tr if residual else None,
                      eps=1e-5)
    assert got.dtype == torch.bfloat16
    _within_one_bf16_step(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_norm_use_pallas_casts_the_weight_to_x_dtype():
    """``norm(use_pallas=True)`` on bf16 activations casts the float32
    weight to bf16 before the kernel (``layers.py:57``); the plain norm
    multiplies by the float32 weight, and the two differ."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    jcfg = jax_config("internlm2-1.8b", smoke=True)
    x, _ = _arrays(5, (2, 9, cfg.d_model))
    w = 1.0 + 0.3 * _arrays(6, (cfg.d_model,), 1)[0]
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    want = jlayers.norm(jcfg, {"n": jnp.asarray(w)}, "n", jx, use_pallas=True)
    got = layers.norm(cfg, {"n": torch.from_numpy(w)}, "n", tx,
                      use_pallas=True)
    assert got.dtype == torch.bfloat16
    _within_one_bf16_step(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    plain = layers.norm(cfg, {"n": torch.from_numpy(w)}, "n", tx)
    assert (plain != got).any()
    np.testing.assert_array_equal(
        plain.float().numpy(),
        np.asarray(jlayers.norm(jcfg, {"n": jnp.asarray(w)}, "n", jx)
                   .astype(jnp.float32)))


def test_norm_use_rtcg_matches_jax():
    cfg = get_config("internlm2-1.8b", smoke=True)
    jcfg = jax_config("internlm2-1.8b", smoke=True)
    x, w = _arrays(7, (2, 3, cfg.d_model))
    w = w[0, 0]
    want = jlayers.norm(jcfg, {"n": jnp.asarray(w)}, "n", jnp.asarray(x),
                        use_rtcg=True)
    got = layers.norm(cfg, {"n": torch.from_numpy(w)}, "n",
                      torch.from_numpy(x), use_rtcg=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_kernel_refuses_what_it_does_not_take():
    x = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms.cuda_rmsnorm(x, torch.ones(64))
    with pytest.raises(ValueError, match="block_rows"):
        ops.rmsnorm(x, torch.ones(64), block_rows=0)


@pytest.mark.parametrize("dtype", rms.DTYPES)
@pytest.mark.parametrize("wdtype", rms.DTYPES)
@pytest.mark.parametrize("residual", [False, True])
def test_every_instance_renders_with_its_launch_signature(dtype, wdtype,
                                                          residual):
    name, _ = rms.instance(dtype, wdtype, residual)
    src = rms.render(dtype, wdtype, residual)
    assert ("rr + c" in src) == residual
    sig = re.search(rf'extern "C" int {name}_launch\((.*?)\)\s*\{{', src,
                    re.S).group(1)
    assert len(sig.split(",")) == len(rms._ARGTYPES)
    vals = [0, 0, 0, None, 0, 12, 2048, 1e-6, 1]
    assert [type(t(x)) for t, x in zip(rms._ARGTYPES, vals)] == rms._ARGTYPES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", rms.DTYPES)
@pytest.mark.parametrize("D", [100, 2048, 5120])
def test_card_kernel_matches_plain(dtype, D):
    """On the card: both kernel forms (a warp per row, a block per row
    at D >= 4096), 16-byte and element loads, with and without a
    residual, against the plain version on the same tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import dispatch

    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((37, D), generator=gen, device="cuda").to(dtype)
    r = torch.randn((37, D), generator=gen, device="cuda").to(dtype)
    w = torch.rand(D, generator=gen, device="cuda").to(dtype)
    for res in (None, r):
        with dispatch.count_launches() as c:
            got = ops.rmsnorm(x, w, res)
            torch.cuda.synchronize()
        assert c.by_kernel == {"rmsnorm": 1}
        want = rmsnorm_ref(x, w, res)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **F32)
        else:
            _within_one_bf16_step(got.float().cpu().numpy(),
                                  want.float().cpu().numpy())
