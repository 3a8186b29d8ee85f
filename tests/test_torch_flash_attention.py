"""Parity of the port's flash attention with the JAX package's Pallas kernel.

The same seeded numpy inputs go through ``pallas_flash_attention`` (in
interpret mode on the CPU, as ``tests/test_kernels.py`` runs it) and the
port's `ops.flash_attention` on CPU tensors, which is the CUDA kernel's
plain version.  Each test pins one point of the contract where the
Pallas kernel differs from a textbook flash attention: top-left causal
alignment, the finite -1e30, p rounded to the value dtype, the l == 0
guard, the kv-padding mask and the GQA index map.  Tolerances: float32
at 2e-3 and bfloat16 at 5e-2, as in ``tests/test_kernels.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jfa
from repro.kernels.flash_attention.flash_attention import (
    pallas_flash_attention)
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as tattn

F32 = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _qkv(seed, B, H, Hk, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D), dtype=np.float32),
            rng.standard_normal((B, Hk, Skv, D), dtype=np.float32),
            rng.standard_normal((B, Hk, Skv, D), dtype=np.float32))


def _both(q, k, v, dtype="float32", **kw):
    """(port, JAX) outputs as float32 numpy for the same inputs."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = pallas_flash_attention(*(jnp.asarray(a).astype(jdt)
                                    for a in (q, k, v)), **kw)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), **kw)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("B,H,Hk,S,D", [(1, 4, 4, 256, 64), (2, 8, 2, 384, 64),
                                        (1, 6, 1, 200, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_gqa(B, H, Hk, S, D, causal):
    got, want = _both(*_qkv(0, B, H, Hk, S, S, D), causal=causal)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("bq,bkv", [(128, 128), (256, 128), (128, 256),
                                    (512, 512)])
def test_block_sweep(bq, bkv):
    got, want = _both(*_qkv(1, 1, 2, 2, 512, 512, 64), causal=True,
                      block_q=bq, block_kv=bkv)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16(causal):
    q, k, v = _qkv(2, 1, 2, 2, 256, 256, 64)
    got, want = _both(q, k, v, "bfloat16", causal=causal)
    np.testing.assert_allclose(got, want, **BF16)


def test_bf16_rounds_p_to_the_value_dtype():
    """With bf16 operands the port agrees with the Pallas kernel to one
    bf16 step of the output; an otherwise equal online softmax that
    keeps p in float32 does not."""
    q, k, v = _qkv(3, 1, 2, 2, 128, 128, 32)
    got, want = _both(q, k, v, "bfloat16", causal=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    f32_p = fa.flash_attention_plain(qt, kt, vt.float()).float().numpy()
    assert np.abs(f32_p - want).max() > 4 * np.abs(got - want).max()


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_skip_masked_blocks_both_ways(skip, dtype):
    q, k, v = _qkv(4, 1, 4, 2, 384, 384, 32)
    got, want = _both(q, k, v, dtype, causal=True, block_q=128, block_kv=64,
                      skip_masked_blocks=skip)
    np.testing.assert_allclose(got, want, **(F32 if dtype == "float32"
                                             else BF16))
    other, _ = _both(q, k, v, dtype, causal=True, block_q=128, block_kv=64,
                     skip_masked_blocks=not skip)
    np.testing.assert_array_equal(got, other)


def test_causal_is_top_left_when_sq_differs_from_skv():
    """Sq=128, Skv=256: row r sees columns c <= r, as the Pallas kernel
    does — not the reference's bottom-right tril(k=Skv-Sq)."""
    q, k, v = _qkv(5, 1, 4, 2, 128, 256, 32)
    got, want = _both(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, **F32)
    bottom_right = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True))
    assert np.abs(got - bottom_right).max() > 0.1


@pytest.mark.parametrize("Hk", [1, 2, 4])
def test_gqa_index_map(Hk):
    """q head h reads kv head h // (H // Hk): each kv head fed to its
    group of q heads alone gives the same rows."""
    q, k, v = _qkv(6, 2, 4, Hk, 200, 200, 32)
    got, want = _both(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, **F32)
    g = 4 // Hk
    for h in range(4):
        kv = h // g
        alone = ops.flash_attention(
            torch.from_numpy(q[:, h:h + 1]), torch.from_numpy(k[:, kv:kv + 1]),
            torch.from_numpy(v[:, kv:kv + 1]), causal=True).numpy()
        np.testing.assert_allclose(got[:, h:h + 1], alone, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("Sq,Skv", [(200, 200), (1, 1), (130, 70)])
def test_kv_padding_mask(Sq, Skv):
    """Columns past Skv (the padded kv block) never weigh in."""
    got, want = _both(*_qkv(7, 1, 2, 1, Sq, Skv, 16), causal=False)
    np.testing.assert_allclose(got, want, **F32)


def test_neg_inf_is_finite_and_l_zero_reads_as_one():
    assert fa.NEG_INF == jfa.NEG_INF == jattn.NEG_INF == -1e30
    acc = torch.zeros((1, 2, 3, 4))
    l = torch.tensor([0.0, 2.0, 0.0]).reshape(1, 1, 3, 1).expand(1, 2, 3, 1)
    out = fa.finish(acc + 1.0, l, torch.float32)
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out[0, 0, :, 0].numpy(), [1.0, 0.5, 1.0])


def test_attention_ref_matches_jax():
    q, k, v = _qkv(8, 1, 4, 2, 96, 160, 32)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_model_pallas_path_matches_jax():
    """`models.attention.attention` with attention_impl="pallas" moves
    the head axis, calls the kernel path and moves it back."""
    from repro.configs.registry import get_config as jax_config
    from repro_torch.configs.registry import get_config

    cfg = get_config("internlm2-1.8b", smoke=True).replace(
        attention_impl="pallas")
    jcfg = jax_config("internlm2-1.8b", smoke=True).replace(
        attention_impl="pallas")
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    want = jattn.attention(jcfg, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v), causal=True)
    got = tattn.attention(cfg, torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_tuner_waits_for_its_roadmap_item():
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        ops.flash_attention_tuned(q, q, q)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        ops.tune_report(q, q, q)


def test_kernel_refuses_what_it_does_not_take():
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.cuda_flash_attention(q, q, q)
    with pytest.raises(ValueError, match="H % Hk"):
        ops.flash_attention(q, torch.zeros((1, 3, 8, 64)),
                            torch.zeros((1, 3, 8, 64)))


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", fa.DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_every_instance_renders_with_its_launch_signature(D, dtype, causal):
    """Each (D, dtype, causal) source renders, names its kernel and
    launch function, and its launch function takes exactly the
    arguments the wrapper binds."""
    name, _ = fa.instance(D, dtype, causal)
    src = fa.render(D, dtype, causal)
    assert f"constexpr int kD = {D};" in src
    assert ("mma.sync" in src) == (dtype == torch.bfloat16)
    sig = re.search(rf'extern "C" int {name}_launch\((.*?)\)\s*\{{', src,
                    re.S).group(1)
    assert len(sig.split(",")) == len(fa._ARGTYPES)
    # the argument types the wrapper declares take the values it passes
    vals = [0, 0, 0, 0, 0, 2, 8, 4, 100, 100] + [1] * 9 + [0.125, 1]
    assert [type(t(x)) for t, x in zip(fa._ARGTYPES, vals)] == fa._ARGTYPES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", fa.DTYPES)
@pytest.mark.parametrize("D", [16, 64])
def test_card_kernel_matches_plain_on_strided_views(dtype, D):
    """On the card: the kernel on the model's strided (B, S, H, D) views
    against its plain version on the same tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import dispatch

    gen = torch.Generator("cuda").manual_seed(0)
    q = torch.randn((2, 77, 4, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((2, 77, 2, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((2, 77, 2, D), generator=gen, device="cuda").to(dtype)
    args = [t.transpose(1, 2) for t in (q, k, v)]
    tol = F32 if dtype == torch.float32 else BF16
    for causal in (True, False):
        with dispatch.count_launches() as c:
            got = ops.flash_attention(*args, causal=causal)
            torch.cuda.synchronize()
        assert c.by_kernel == {"flash_attention": 1} and c.by_backend == {}
        want = fa.flash_attention_plain(*args, causal=causal)
        assert torch.isfinite(got.float()).all()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)
        # every output row to rounding (see chip_smoke.FLASH_ROW_TOL)
        g, w = got.double(), want.double()
        row_rel = ((g - w).norm(dim=-1) / w.norm(dim=-1)).max()
        assert row_rel <= (1e-5 if dtype == torch.float32 else 2e-2)
