"""Core layer of the PyTorch port against the JAX package: hashing,
bucketing, dtypes, snippets, backend resolution, the CUDA C renders (as
text — nothing is compiled here) and the import boundary."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import dispatch as jdispatch
from repro.core.platform import canonical_dtype as jcanonical
from repro_torch.core import backends, cache, dispatch, rtcg, snippets
from repro_torch.core.platform import canonical_dtype, dtype_name, resolve_device
from repro_torch.runtime import _ragged_kernels

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


# ---------------------------------------------------------------- hashing
@pytest.mark.parametrize("token", [
    "expf(x[i] - _acc0)", b"\x00\x01bytes",
    ["reduce", "w", [("x", "float32", "full")], 3, None],
    {"b": 1.5, "a": [1, 2, {"z": "y"}]},
])
def test_stable_hash_matches_jax(token):
    assert cache.stable_hash(token) == jcache.stable_hash(token)


def test_lru_cache_bounds_and_counts():
    lru = cache.LRUCache(maxsize=2)
    for k in "abc":
        lru.get_or_create(k, lambda k=k: k.upper())
    assert len(lru) == 2 and "a" not in lru and lru.get("c") == "C"
    st = lru.stats()
    assert st["evictions"] == 1 and st["hits"] == 1


def test_environment_fingerprint_fields():
    fp = cache.environment_fingerprint("eager")
    assert fp["torch"] == torch.__version__ and fp["rtcg_backend"] == "eager"
    assert {"cuda", "sm", "device_kind", "ir_schema"} <= set(fp)
    assert "jax" not in fp
    assert cache.environment_fingerprint("cuda")["rtcg_backend"] == "cuda"


# -------------------------------------------------------------- bucketing
SIZES = [1, 2, 3, 7, 8, 9, 31, 32, 33, 127, 128, 129, 1000, 1023, 1024,
         1025, 4096, 92544, 131073]


@pytest.mark.parametrize("fn", ["next_pow2", "bucket_cols",
                                "default_batch_block"])
def test_bucket_functions_match_jax(fn):
    for x in SIZES:
        assert getattr(dispatch, fn)(x) == getattr(jdispatch, fn)(x), x


def test_batch_and_pair_buckets_match_jax():
    for b in SIZES[:12]:
        for br in (1, 2, 4, 8, 256):
            assert dispatch.bucket_batch(b, br) == jdispatch.bucket_batch(b, br)
        for n in SIZES:
            for kw in ({}, {"ragged": True}, {"transposed": True}):
                assert dispatch.rc_bucket(b, n, **kw) == \
                    jdispatch.rc_bucket(b, n, **kw)


def test_kernel_launch_counts_share_the_dispatch_counters():
    """Per-kernel counts sit beside the per-backend ones: one
    `count_launches` reads both and one `reset_counters` clears both."""
    with dispatch.count_launches() as c:
        dispatch.record_launch("cuda")
        dispatch.record_kernel_launch("row_reduction")
        dispatch.record_launch("cuda")
        dispatch.record_kernel_launch("rows_elementwise")
    assert (c.delta, c.by_backend) == (2, {"cuda": 2})
    assert c.by_kernel == {"row_reduction": 1, "rows_elementwise": 1}
    assert dispatch.stats()["launches_by_kernel"]["row_reduction"] >= 1
    dispatch.reset_counters()
    assert dispatch.kernel_launch_counts() == {}
    assert dispatch.launch_counts() == {}


# ----------------------------------------------------------------- dtypes
@pytest.mark.parametrize("dt", [np.float64, np.float32, np.int64, np.int32,
                                np.uint32, np.bool_, "float64", "int64"])
def test_canonical_dtype_matches_jax_x64_off(dt):
    assert dtype_name(canonical_dtype(dt)) == str(jcanonical(dt))


def test_canonical_dtype_float64_is_float32():
    assert canonical_dtype(torch.float64) is torch.float32
    assert canonical_dtype(np.float64) is torch.float32


# --------------------------------------------------------------- snippets
def test_torch_translation_targets_lifted_functions():
    expr = snippets.translate_expression("x[i] > 0 ? expf(x[i]) : 1.0f")
    assert expr == "_c.where(x > 0, _c.expf(x), 1.0)"
    x = torch.tensor([-1.0, 2.0])
    got = eval(expr, {"_c": snippets.TORCH_NAMESPACE, "x": x})
    assert torch.allclose(got, torch.tensor([1.0, float(np.exp(2.0))]))


def test_c_statement_passes_c_through():
    assert snippets.c_statement("float t = fmaxf(x[i], w[i])") == \
        ("float", "t", "fmaxf(x, w)")
    assert snippets.c_statement("z[i] *= a") == (None, "z", "z * (a)")


def test_extract_cumsum_innermost_first():
    expr, found = snippets.extract_cumsum(
        "out[i] = 1.0f - cumsumf(expf(cumsumf(x[i])) / r1)")
    assert found == [(0, "x[i]"), (1, "expf(_scan0) / r1")]
    assert expr == "out[i] = 1.0f - _scan1"


# ----------------------------------------------------- backend resolution
def test_backend_resolves_by_device_and_never_falls_back(monkeypatch):
    monkeypatch.delenv(backends.ENV_VAR, raising=False)
    assert backends.get_backend(None, torch.zeros(2)).name == "eager"
    assert backends.get_backend("cuda").name == "cuda"
    wave = _ragged_kernels("softmax")[0]
    with pytest.raises(ValueError, match="CUDA tensors"):
        wave(torch.zeros(2, 8), backend="cuda")
    with pytest.raises(NotImplementedError):
        backends.get_backend("auto")
    with pytest.raises(ValueError):
        backends.get_backend("pallas")


def test_backend_env_variable_is_the_ports_own(monkeypatch):
    monkeypatch.setenv("REPRO_BACKEND", "pallas")   # the JAX package's knob
    monkeypatch.setenv(backends.ENV_VAR, "eager")
    assert backends.get_backend(None, torch.zeros(1)).name == "eager"
    monkeypatch.setenv(backends.ENV_VAR, "cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        _ragged_kernels("softmax")[0](torch.zeros(1, 4))


def test_resolve_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_build_dir_override(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert rtcg.build_dir() == ROOT / "build" / "rtcg_kernels"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert rtcg.build_dir() == tmp_path
    assert "arch=compute_90a,code=sm_90a" in rtcg.NVCC_FLAGS


# --------------------------------------------------- CUDA renders as text
def _render(family, part, ragged=True, block_rows=8, ncols=1024):
    k = _ragged_kernels(family)[part]
    return k.render(block_rows, ncols, backend="cuda", ragged=ragged)


def test_cuda_render_ragged_softmax_wave():
    src = _render("softmax", 0)
    # per-row length, running on into the zero padding of the row's
    # bucket past n, as the JAX package's padded blocks do
    assert "min(_row_lens[_r], _ncols)" in src
    assert "const float x = _in ? x_row[_c] : (float)0;" in src
    assert src.count("for (int _c = threadIdx.x; _c < _len;") == 2  # 1 sweep/level
    assert "_v = Combine0()(_v, (float)(x));" in src
    assert "_v = Combine1()(_v, (float)(expf(x - _acc0)));" in src
    assert "const float _acc0 = _bcast0;" in src         # level broadcast
    assert re.search(r'extern "C" int ragged_softmax_wave_launch\(', src)
    assert "return (int)cudaGetLastError();" in src
    assert "pallas.py" in src and "line 391" in src      # what it replaces


def test_cuda_render_cdf_epilogue_has_row_scan():
    src = _render("softmax.cdf", 1)
    assert "cumsumf" not in src.split("#include")[1]
    assert "block_inclusive_scan(_pre0, _carry0, _wtot)" in src
    assert "__shfl_up_sync" in src
    assert "const float _pre0 = (float)(expf(x - r0) / r1);" in src
    assert "out_out[_r * out_os + _c] = _c < _len ? out : (float)0;" in src
    assert re.search(r'extern "C" int ragged_softmax_cdf_epi_launch\(', src)
    assert "return (int)cudaGetLastError();" in src


def test_cuda_render_pointwise_epilogue_is_a_2d_grid():
    src = _render("rmsnorm", 1, ragged=False)
    assert "block_inclusive_scan" not in src
    assert "blockIdx.y" in src and "float eps" in src
    assert "out = (float)(x / sqrtf(r0 / L + eps) * w);" in src


@pytest.mark.parametrize("family,part", [("softmax", 0), ("softmax.cdf", 1),
                                         ("rmsnorm", 1)])
def test_cuda_source_does_not_bake_the_bucket(family, part):
    assert _render(family, part, block_rows=1, ncols=128) == \
        _render(family, part, block_rows=64, ncols=131072)


# ------------------------------------------------------ import boundary
def test_port_imports_neither_jax_nor_repro():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
              "assert not bad, bad\nprint(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def test_no_jax_or_repro_import_in_the_port_sources():
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not bad, bad
