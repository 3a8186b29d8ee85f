#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: the card's name and power limit (``nvidia-smi``), torch,
   CUDA, ``nvcc --version``, jinja2;
2. build: renders every CUDA kernel instance — of the serving path, the
   ragged runtime families, the RTCG library (flat elementwise, flat
   and column reductions, scans), flash attention for each (head dim,
   dtype, causal) of phases 3 and 7 and RMSNorm for (float32, bfloat16)
   x (residual or not) — from the templates under
   ``src/repro_torch/csrc`` and compiles them with ``nvcc`` for
   ``sm_90a``, one ``nvcc`` per source, all started together;
3. every instance against its plain version (the ``eager`` backend) on
   the same card tensors: the rows kernels at K in {1, 3, 8, 64} x N in
   {1, 1023, 92544, 131073} with mixed row lengths, and row lengths past
   the width; the flat kernels at n up to 2**27, every reducer, the
   column form at (3, 1023), (1023, 3) and (8192, 2048), the four scans
   inclusive and exclusive at n up to 2**27; flash attention over
   `FLASH_SHAPES` x causal or not x (float32, bfloat16), the causal
   cases with ``skip_masked_blocks`` both ways (each case's worst error
   printed); RMSNorm over `RMS_SHAPES` x dtype x residual, and at
   (4096, 2048) float32 against the RTCG ``rtcg_rmsnorm``;
4. the serving path: ``internlm2-1.8b`` at full width in bf16 (random
   weights from a seed) served by ``ContinuousEngine(capacity=8,
   max_len=1024)`` with ``ServingRuntime(backend="cuda")``: 12 prompts
   of 32-200 tokens, 24 new tokens each at temperature 0.8; every step
   must be exactly 2 launches, both ``cuda``, one of each kernel; real
   model logits rows go through the flush on the kernels and on their
   plain version; then 3 steady steps of 8 live requests are timed, and
   3 more under ``torch.profiler`` say where a step's time goes; an
   engine without a runtime samples on the card, with no host copy;
5. the library path at sizes users run (the quickstart's sections 1-3c
   on the card): lin_comb, map-reduce, dot, two accumulators, variance
   and a prefix scan over 2**27 elements, a 1-D softmax over 2**24, a
   stable row softmax over (64, 92544), a batched rmsnorm over (4096,
   2048), a column softmax over (8192, 2048), and ``ServingRuntime``'s
   dense ``softmax``/``rmsnorm``/``sample`` plus 64 concurrent
   ``submit_softmax`` rows in one flush; each result against the plain
   version and each launch count against the JAX package's (the parity
   tests pin them), every launch ``cuda``;
6. times: each kernel's device time (``torch.profiler``) and its
   wrapper's time per call (CUDA events), its plain version, its bound,
   and a library yardstick the port never calls — the rows kernels at
   the serving shape (K=8, V=92544), the library kernels at 2**27,
   flash attention at (1, 16, 8, S, S, 128) bf16 causal for S in {1024,
   4096} against ``scaled_dot_product_attention``, RMSNorm at (4096,
   2048) bf16 with and without a residual and at (16384, 2048) against
   ``F.rms_norm``, these two kernels with the L2 written over before
   each timed call;
7. prefill through the flash-attention kernel (``attention_impl=
   "pallas"``, phase 4's weights and prompts, run after phase 4): (a)
   ``ContinuousEngine`` + the cuda runtime, where every admission is
   exactly 24 flash launches (one per layer) and every step still 2
   ``cuda`` launches, the kernel held against its plain version on the
   first admission's layer-0 q/k/v and the first admission's logits
   against the ``flash_jnp`` engine's (relative L2 <= 5e-2, the
   ``naive`` engine's reading beside it), then the prefill ms p50 per
   admission of both ``attention_impl`` settings on the served rows, in
   a pass of its own outside the serving loop; (b) the static ``Engine`` +
   ``RequestQueue`` in blocks of 4, each left-padded to a width that is
   no multiple of the kernel's tile, 24 flash launches per block; (c)
   the norm path: ``layers.norm(use_pallas=True)`` with each of the
   model's RMSNorm weights plus one fused-residual ``ops.rmsnorm``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
MAIN_K, MAIN_V = 8, 92544     # sampler flush at the main path: 8 live rows
LIB_N = 1 << 27               # the library path's vectors: 512 MiB of f32
SEED = 0


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------ phase 1
def environment() -> str:
    import jinja2
    import torch

    from repro_torch.core import rtcg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} jinja2 {jinja2.__version__}")
    log(f"device {torch.cuda.get_device_name(0)} capability "
        f"{torch.cuda.get_device_capability(0)} count "
        f"{torch.cuda.device_count()}")
    log(rtcg.nvcc_version().strip().splitlines()[-1])
    return smi


# ------------------------------------------------------------ phase 2
def instances():
    """Every kernel instance of the serving path and the ragged runtime
    families: (label, kernel, ragged)."""
    from repro_torch.runtime import _ragged_kernels

    wave, soft_epi = _ragged_kernels("softmax")
    _, cdf_epi = _ragged_kernels("softmax.cdf")
    rms_wave, rms_epi = _ragged_kernels("rmsnorm")
    return [
        ("softmax_wave.ragged", wave, True),
        ("softmax_cdf_epi.ragged", cdf_epi, True),
        ("softmax_epi.ragged", soft_epi, True),
        ("rmsnorm_wave.ragged", rms_wave, True),
        ("rmsnorm_epi.ragged", rms_epi, True),
        ("softmax_wave.dense", wave, False),
        ("softmax_epi.dense", soft_epi, False),
    ]


def library_kernels() -> dict:
    """One instance of every library kernel form, by label: the flat
    elementwise pass (float32 with scalars; int32 with the global index),
    the flat reduction with every reducer, single and multi-accumulator,
    the column reduction, and the four scans, inclusive and exclusive."""
    from repro_torch.core import (ElementwiseKernel, ExclusiveScanKernel,
                                  InclusiveScanKernel, ReductionKernel)

    f32 = "float32"
    ks = {
        "axpy": ElementwiseKernel("float a, float *x, float *y, float *z",
                                  "z[i] = x[i] + a*y[i]", name="axpy"),
        "iota_i32": ElementwiseKernel("int *o, int *v", "o[i] = v[i] * 3 + i",
                                      name="iota_i32"),
        "stats3": ReductionKernel(
            [f32] * 3, ["3.4e38", "-3.4e38", "0"],
            ["fminf(a,b)", "fmaxf(a,b)", "a+b"], ["x[i]"] * 3, "float *x",
            name="lib_stats3"),
        "isum_wrap": ReductionKernel("int32", "0", "a+b", "x[i] * 7",
                                     "int *x", name="lib_isum"),
        "col_wave": ReductionKernel([f32, f32], ["-3.4e38", "0"],
                                    ["fmaxf(a, b)", "a + b"],
                                    ["x[i]", "expf(x[i] - _acc0)"],
                                    "float *x", axis=0, name="lib_col_wave"),
        "col_sum": ReductionKernel(f32, "0", "a+b", "x[i]", "float *x",
                                   axis=0, name="lib_col_sum"),
    }
    for label, neutral, rexpr, mexpr in REDUCERS:
        ks[label] = ReductionKernel(f32, neutral, rexpr, mexpr,
                                    "float *x, float *y", name=f"lib_{label}")
    for tag, op, neutral in SCAN_OPS:
        ks[f"scan_{tag}.incl"] = InclusiveScanKernel(f32, op,
                                                     name=f"scan_{tag}")
        ks[f"scan_{tag}.excl"] = ExclusiveScanKernel(
            f32, op, neutral, name=f"scan_{tag}_excl")
    return ks


#: flat reducers: (label, neutral, reduce_expr, map_expr over x and y)
REDUCERS = [("sum", "0", "a+b", "x[i]"), ("dot", "0", "b+a", "x[i]*y[i]"),
            ("prod", "1", "a*b", "x[i]"),
            ("fmaxf", "-3.4e38", "fmaxf(a,b)", "x[i] + y[i]"),
            ("max", "-3.4e38", "max(a,b)", "x[i]"),
            ("fminf", "3.4e38", "fminf(a,b)", "fabsf(x[i])"),
            ("min", "3.4e38", "min(a,b)", "y[i]")]
SCAN_OPS = [("sum", "a+b", "0"), ("prod", "a*b", "1"),
            ("max", "fmaxf(a,b)", "-3e38"), ("min", "fminf(a,b)", "3e38")]


def _source(k, ragged: bool = False) -> str:
    """The CUDA source of one kernel instance (what its driver builds)."""
    from repro_torch.core import ReductionKernel, ScanKernel

    if isinstance(k, ScanKernel):
        return k.render(backend="cuda")
    if (isinstance(k, ReductionKernel) and k.axis is None) or \
            getattr(k, "layout", None) == "flat":
        return k.render(8, backend="cuda")
    return k.render(1, 128, backend="cuda", ragged=ragged)


def build(jobs, what: str) -> None:
    """Compile (label, name, source) jobs: one nvcc per source, all
    started together."""
    from repro_torch.core.rtcg import CudaSourceModule

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        mods = list(ex.map(lambda j: CudaSourceModule.load(j[2], name=j[1]),
                           jobs))
    log(f"build {what}: {len(jobs)} instances, {len({m.path for m in mods})} "
        f"sources, {time.perf_counter() - t0:.2f} s wall")
    for (label, _, _), m in zip(jobs, mods):
        usage = [ln.split("ptxas info    : ")[-1].strip() for ln in
                 m.build_log.splitlines() if "Used" in ln or (
                     "spill" in ln and " 0 bytes spill stores" not in ln)]
        log(f"  {label}: {m.path.relative_to(ROOT) if m.path.is_relative_to(ROOT) else m.path}"
            f" compiled={m.compiled} {' '.join(usage)}")


#: head dims of the flash-attention instances phases 3 and 7 use
FLASH_DIMS = (32, 64, 128)


def kernel_jobs() -> list:
    """(label, name, source) of the hand-written kernels' instances:
    flash attention for each (head dim, dtype, causal) of phases 3 and 7,
    RMSNorm for (float32, bfloat16) x (residual or not), w in x's dtype."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.rmsnorm import rmsnorm as rms

    jobs = []
    for D in FLASH_DIMS:
        for dt in fa.DTYPES:
            for causal in (True, False):
                name, _ = fa.instance(D, dt, causal)
                jobs.append((name, name, fa.render(D, dt, causal)))
    for dt in rms.DTYPES:
        for res in (False, True):
            name, _ = rms.instance(dt, dt, res)
            jobs.append((name, name, rms.render(dt, dt, res)))
    return jobs


def build_all(lib: dict) -> None:
    jobs = [(label, k.name, _source(k, ragged))
            for label, k, ragged in instances()]
    jobs += [(label, k.name, _source(k)) for label, k in lib.items()]
    build(jobs + kernel_jobs(), "kernel instances")


# ------------------------------------------------------------ phase 3
def _inputs(K: int, N: int, gen, device):
    import torch

    X = torch.randn((K, N), generator=gen, device=device) * 3.0
    lens = torch.randint(1, N + 1, (K,), generator=gen, device=device,
                         dtype=torch.int32)
    lens[0] = N
    if K > 1:
        lens[-1] = 1
    return X, lens


def _call(label, k, X, lens, backend, gen_args):
    """One call of an instance on (X, lens) through ``backend``."""
    ragged = label.endswith(".ragged")
    rl = lens if ragged else None
    if "wave" in label:
        return k(X, backend=backend, row_lens=rl)
    if label.startswith("rmsnorm"):
        r0, L, w = gen_args
        return k(r0, L, w, 1e-6, X, X, backend=backend, row_lens=rl)
    r0, r1 = gen_args
    return k(r0, r1, X, X, backend=backend, row_lens=rl)


def _epilogue_args(label, X, lens, device):
    """Reduced inputs of an epilogue, from the plain wave (the same
    tensors feed the kernel and its plain version)."""
    import torch

    from repro_torch.runtime import _ragged_kernels

    ragged = label.endswith(".ragged")
    rl = lens if ragged else None
    if label.startswith("rmsnorm"):
        wave = _ragged_kernels("rmsnorm")[0]
        r0 = wave(X, backend="eager", row_lens=rl)
        L = (lens if ragged else torch.full_like(lens, X.shape[1])).float()
        w = torch.linspace(0.5, 1.5, X.shape[1], device=device)
        return r0, L, w
    return _ragged_kernels("softmax")[0](X, backend="eager", row_lens=rl)


#: per-output tolerance (rtol, atol) and why
TOL = {
    "softmax_wave": [(0.0, 0.0), (1e-5, 0.0)],   # row max exact; exp-sum in another order
    "rmsnorm_wave": [(1e-5, 0.0)],               # sum of squares in another order
    "softmax_epi": [(0.0, 1e-6)],                # expf / torch.exp, one division
    "softmax_cdf_epi": [(0.0, 1e-4)],            # f32 prefix sums in another order
    "rmsnorm_epi": [(1e-5, 1e-6)],               # sqrtf and two divisions
}


def compare_all(device) -> dict:
    import torch

    from repro_torch.core.dispatch import bucket_cols

    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = [(K, N) + _inputs(K, N, gen, device)
             for K in (1, 3, 8, 64) for N in (1, 1023, 92544, 131073)]
    for N in (1, 1023, 92544):
        # row lengths past the width: the columns up to the row's bucket
        # count with zero operands, as in the JAX package's padded blocks
        lens = torch.tensor([N + 1, bucket_cols(N), bucket_cols(N) + 3, 1],
                            dtype=torch.int32, device=device)
        cases.append((4, N, torch.randn((4, N), generator=gen,
                                        device=device) * 3.0, lens))
    worst: dict = {}
    for K, N, X, lens in cases:
        for label, k, _ in instances():
            args = None if "wave" in label else _epilogue_args(
                label, X, lens, device)
            got = _call(label, k, X, lens, "cuda", args)
            ref = _call(label, k, X, lens, "eager", args)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            for j, (g, r) in enumerate(zip(got, ref)):
                rtol, atol = TOL[label.split(".")[0]][j]
                err = float((g - r).abs().max())
                bound = atol + rtol * r.abs()
                if not bool(((g - r).abs() <= bound).all()):
                    raise AssertionError(
                        f"{label} output {j} at K={K} N={N}: max abs "
                        f"err {err} beyond rtol={rtol} atol={atol}")
                key = (label, j)
                worst[key] = max(worst.get(key, 0.0), err)
    for (label, j), err in sorted(worst.items()):
        log(f"  {label} out{j}: max abs err {err:.3e} "
            f"(rtol={TOL[label.split('.')[0]][j][0]}, "
            f"atol={TOL[label.split('.')[0]][j][1]})")
    return worst


def _close(what: str, got, ref, kind: str, scale=None, rtol=None) -> float:
    """Hold a kernel's result against its plain version; the max abs
    error.  ``pointwise``: rtol 1e-6, atol 1e-6 (the same float32
    arithmetic, fused multiply-adds aside); ``exact``: equal (max/min,
    integers, wraparound included); ``sum``: |d| <= 1e-5 * scale + 1e-6
    with ``scale`` the sum of the absolute terms (float32 sums in another
    order); ``prod``: rtol (float32 products in another order)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"plain {ref.dtype} {tuple(ref.shape)}")
    d = (got.double() - ref.double()).abs()
    bound = {"exact": lambda: 0.0,
             "pointwise": lambda: 1e-6 + 1e-6 * ref.double().abs(),
             "sum": lambda: 1e-5 * scale + 1e-6,
             "prod": lambda: rtol * ref.double().abs()}[kind]()
    if not bool((d <= bound).all()):
        raise AssertionError(f"{what}: max abs err {float(d.max())} beyond "
                             f"the {kind} tolerance")
    return float(d.max()) if d.numel() else 0.0


def _powers_of_two(n: int, gen, device):
    """n factors whose every partial product is exact in float32: ones,
    with 100 twos, 100 halves and three minus ones at random places (the
    running exponent stays within +-100).  A float32 product of 2**27
    factors near 1 depends on the order of its multiplies by whole per
    cent, so no tolerance would tell a right kernel from a wrong one."""
    import torch

    x = torch.ones(n, device=device)
    at = torch.randint(0, n, (203,), generator=gen, device=device)
    x[at[:100]], x[at[100:200]], x[at[200:]] = 2.0, 0.5, -1.0
    return x


FLAT_NS = (1, 127, 128, 129, 4097, LIB_N - 3, LIB_N)
SCAN_NS = (1, 4095, 4096, 4097, LIB_N)


def compare_library(device, lib: dict) -> dict:
    """Every library kernel instance against its plain version on the
    same card tensors; the worst abs error per kernel."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    worst: dict = {}

    def run(kernel_row, what, k, args, kind, scale=None, rtol=None):
        got = k(*args, backend="cuda")
        ref = k(*args, backend="eager")
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        kinds = kind if isinstance(kind, tuple) else (kind,) * len(got)
        scales = scale if isinstance(scale, tuple) else (scale,) * len(got)
        torch.cuda.synchronize()
        for j, (g, r, kd, sc) in enumerate(zip(got, ref, kinds, scales)):
            err = _close(f"{what} out{j}", g, r, kd, sc, rtol)
            worst[kernel_row] = max(worst.get(kernel_row, 0.0), err)

    def ints(*shape, lo=-1000, hi=1000):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    for n in FLAT_NS:
        x = torch.randn(n, generator=gen, device=device)
        y = torch.randn(n, generator=gen, device=device)
        run("flat_elementwise", f"axpy n={n}", lib["axpy"], (2.5, x, y, x),
            "pointwise")
        v = ints(n)
        run("flat_elementwise", f"iota_i32 n={n}", lib["iota_i32"], (v, v),
            "exact")
    for n in (1, 4097, LIB_N):
        x = torch.randn(n, generator=gen, device=device)
        y = torch.randn(n, generator=gen, device=device)
        near1 = 0.999 + 0.002 * torch.rand(n, generator=gen, device=device) \
            if n <= 4097 else _powers_of_two(n, gen, device)
        xd, yd = x.double(), y.double()
        for label, _, rexpr, _ in REDUCERS:
            args = (near1, y) if label == "prod" else (x, y)
            if label == "sum":
                run("flat_reduction", f"sum n={n}", lib[label], args, "sum",
                    float(xd.abs().sum()))
            elif label == "dot":
                run("flat_reduction", f"dot n={n}", lib[label], args, "sum",
                    float((xd * yd).abs().sum()))
            elif label == "prod":   # rtol 1e-4: float32 products, 4097 terms
                run("flat_reduction", f"prod n={n}", lib[label], args,
                    "prod" if n <= 4097 else "exact", rtol=1e-4)
            else:
                run("flat_reduction", f"{label} n={n}", lib[label], args,
                    "exact")
        # integer-valued float32 terms in [-8, 8]: every partial sum the
        # kernel or its plain version forms is an integer far below
        # 2**24, so the result is exact in any order, and one partial or
        # block dropped or read twice must show at 2**27 as well
        xi, yi = ints(n, lo=-8, hi=9).float(), ints(n, lo=-8, hi=9).float()
        run("flat_reduction", f"sum_exact n={n}", lib["sum"], (xi, yi),
            "exact")
        run("flat_reduction", f"dot_exact n={n}", lib["dot"], (xi, yi),
            "exact")
        run("flat_reduction", f"stats3 n={n}", lib["stats3"], (x,),
            ("exact", "exact", "sum"), (None, None, float(xd.abs().sum())))
        if n > 1:   # int32 sums that wrap around 2**32
            run("flat_reduction", f"isum_wrap n={n}", lib["isum_wrap"],
                (ints(n, lo=-2**31, hi=2**31 - 1),), "exact")
    # the sum on two streams at once: each stream has its own last-block
    # ticket, so no grid folds the other's partials (exact terms again)
    xs = [ints(1 << 24, lo=-8, hi=9).float() for _ in range(2)]
    want = [lib["sum"](x, x, backend="eager") for x in xs]
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for _ in range(16):
        for j, st in enumerate(streams):
            with torch.cuda.stream(st):
                got.append((j, lib["sum"](xs[j], xs[j], backend="cuda")))
    torch.cuda.synchronize()
    for j, g in got:
        err = _close(f"sum on stream {j}", g, want[j], "exact")
        worst["flat_reduction"] = max(worst.get("flat_reduction", 0.0), err)
    for b, n in ((3, 1023), (1023, 3), (8192, 2048)):
        X = torch.randn((b, n), generator=gen, device=device) * 3.0
        ref_sum = lib["col_wave"](X, backend="eager")[1].double()
        run("row_reduction.axis0", f"col_wave {b}x{n}", lib["col_wave"], (X,),
            ("exact", "sum"), (None, ref_sum))
        run("row_reduction.axis0", f"col_sum {b}x{n}", lib["col_sum"], (X,),
            "sum", X.double().abs().sum(0))
        run("row_reduction.axis0", f"col_sum_exact {b}x{n}", lib["col_sum"],
            (ints(b, n, lo=-8, hi=9).float(),), "exact")
    for label, k in lib.items():
        if not label.startswith("scan_"):
            continue
        for n in SCAN_NS:
            if "prod" in label:   # rtol 1e-4 on [0.9, 1.1]; exact at 2**27
                if n <= 4097:
                    x = 0.9 + 0.2 * torch.rand(n, generator=gen, device=device)
                    run("scan", f"{label} n={n}", k, (x,), "prod", rtol=1e-4)
                else:
                    run("scan", f"{label} n={n}", k,
                        (_powers_of_two(n, gen, device),), "exact")
            elif "sum" in label:
                x = torch.randn(n, generator=gen, device=device)
                terms = torch.cumsum(x.double().abs(), 0)
                if label.endswith("excl"):
                    terms = torch.cat([terms.new_zeros(1), terms[:-1]])
                run("scan", f"{label} n={n}", k, (x,), "sum", terms)
                # exact on integer-valued terms (see the sums above): a
                # late tile's wrong carry must show
                run("scan", f"{label}_exact n={n}", k,
                    (ints(n, lo=-8, hi=9).float(),), "exact")
            else:
                x = torch.randn(n, generator=gen, device=device)
                run("scan", f"{label} n={n}", k, (x,), "exact")
    for row, err in sorted(worst.items()):
        log(f"  {row}: max abs err {err:.3e}")
    return worst


#: (B, H, Hk, Sq, Skv, D) of the flash-attention checks: the JAX
#: package's test shapes, a decode-sized and a Sq < Skv call, the static
#: path's padded block, and the serving model's prefill lengths
FLASH_SHAPES = [(1, 4, 4, 256, 256, 64), (2, 8, 2, 384, 384, 64),
                (1, 6, 1, 200, 200, 32), (1, 16, 8, 1, 1, 128),
                (1, 16, 8, 128, 256, 128), (4, 16, 8, 200, 200, 128),
                (1, 16, 8, 1024, 1024, 128), (1, 16, 8, 4096, 4096, 128)]
#: rtol = atol per dtype name: float32 as tests/test_kernels.py:70,
#: bfloat16 as tests/test_kernels.py:90
FLASH_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
#: ... and every output row (b, h, r) within this relative L2 error of
#: the plain version's row.  At S=4096 an output row has entries near
#: 0.02, under the absolute tolerance above, so a zeroed row or a
#: dropped kv tile would pass that alone; a sound kernel's rows differ
#: by rounding only (about 1e-6 in float32 and 5e-3 in bfloat16, where
#: p is rounded at other running maxima than the plain version's).
FLASH_ROW_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
RMS_SHAPES = [(1, 1, 128), (3, 17, 512), (4096, 2048), (16384, 2048)]


def _bf16_steps(got, ref) -> float:
    """The largest |got - ref| in units of one bf16 step of ref."""
    import torch

    r = ref.double().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(r)) - 7)
    return float(((got.double() - ref.double()).abs() / ulp).max())


def _row_rel(got, ref) -> float:
    """The largest relative L2 error of an output row (the last axis)."""
    if ref.numel() == 0:
        return 0.0
    g, r = got.double(), ref.double()
    return float(((g - r).norm(dim=-1)
                  / r.norm(dim=-1).clamp_min(1e-30)).max())


def _hold(what: str, got, ref, dtype: str, kind: str) -> float:
    """Hold a hand-written kernel's output against its plain version on
    the same inputs: the same dtype and shape, finite, and within the
    tolerance of ``kind`` (``flash``: FLASH_TOL and FLASH_ROW_TOL;
    ``rms``: float32 at rtol 1e-4, atol 1e-5 as tests/test_kernels.py:98,
    bfloat16 within one bf16 step of the output).  The max abs error."""
    import torch

    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"plain {ref.dtype} {tuple(ref.shape)}")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: non-finite output")
    d = (got.double() - ref.double()).abs()
    if kind == "flash":
        tol = FLASH_TOL[dtype]
        ok = bool((d <= tol + tol * ref.double().abs()).all()) and \
            _row_rel(got, ref) <= FLASH_ROW_TOL[dtype]
    elif dtype == "float32":
        ok = bool((d <= 1e-5 + 1e-4 * ref.double().abs()).all())
    else:
        ok = _bf16_steps(got, ref) <= 1.0
    if not ok:
        raise AssertionError(f"{what}: max abs err {float(d.max())} beyond "
                             f"the {kind} {dtype} tolerance")
    return float(d.max()) if d.numel() else 0.0


def compare_kernels(device) -> dict:
    """The flash-attention and RMSNorm kernels against their plain
    versions on the same card tensors over the grid of shapes; each
    case's worst error printed; the worst per kernel returned."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models.layers import rtcg_rmsnorm

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    worst = {"flash_attention": 0.0, "rmsnorm": 0.0}
    for B, H, Hk, Sq, Skv, D in FLASH_SHAPES:
        qkv = [torch.randn(shape, generator=gen, device=device)
               for shape in ((B, H, Sq, D), (B, Hk, Skv, D), (B, Hk, Skv, D))]
        for dt in fa.DTYPES:
            q, k, v = (t.to(dt) for t in qkv)
            name = str(dt).replace("torch.", "")
            errs, rows = [], []
            for causal, skip in ((True, True), (True, False), (False, True)):
                kw = dict(causal=causal, skip_masked_blocks=skip)
                got = flash_ops.flash_attention(q, k, v, **kw)
                ref = fa.flash_attention_plain(q, k, v, **kw)
                torch.cuda.synchronize()
                errs.append(_hold(f"flash {(B, H, Hk, Sq, Skv, D)} {name} "
                                  f"{kw}", got, ref, name, "flash"))
                rows.append(_row_rel(got, ref))
            worst["flash_attention"] = max(worst["flash_attention"], *errs)
            log(f"  flash_attention {(B, H, Hk, Sq, Skv, D)} {name}: max abs "
                f"err causal+skip {errs[0]:.3e}, causal {errs[1]:.3e}, "
                f"full {errs[2]:.3e} (rtol=atol={FLASH_TOL[name]}); worst "
                f"row relative L2 {max(rows):.3e} "
                f"(<= {FLASH_ROW_TOL[name]})")
    for shape in RMS_SHAPES:
        x32, r32 = (torch.randn(shape, generator=gen, device=device)
                    for _ in range(2))
        w32 = 1.0 + 0.25 * torch.randn(shape[-1], generator=gen,
                                       device=device)
        for dt in (torch.float32, torch.bfloat16):
            x, r, w = x32.to(dt), r32.to(dt), w32.to(dt)
            name = str(dt).replace("torch.", "")
            for res in (None, r):
                got = rms_ops.rmsnorm(x, w, res)
                ref = rmsnorm_ref(x, w, res)
                torch.cuda.synchronize()
                err = _hold(f"rmsnorm {shape} {name} residual="
                            f"{res is not None}", got, ref, name, "rms")
                worst["rmsnorm"] = max(worst["rmsnorm"], err)
                extra = (f" ({_bf16_steps(got, ref):.0f} bf16 steps)"
                         if dt == torch.bfloat16 else "")
                log(f"  rmsnorm {shape} {name} residual={res is not None}: "
                    f"max abs err {err:.3e}{extra}")
        if shape == (4096, 2048):
            # the same function through the RTCG planner (2 launches)
            got = rms_ops.rmsnorm(x32, w32)
            planner = rtcg_rmsnorm(x32, w32, eps=1e-6)
            torch.cuda.synchronize()
            err = _hold("rmsnorm (4096, 2048) float32 vs rtcg_rmsnorm", got,
                        planner, "float32", "rms")
            log(f"  rmsnorm (4096, 2048) float32 vs the RTCG rtcg_rmsnorm: "
                f"max abs err {err:.3e}")
    return worst


# ------------------------------------------------------------ phase 4
def reference_check(device) -> None:
    """The model on the card agrees with the model on the CPU on a small
    input (the SMOKE config in float32, the same weights)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.models.schema import init_params

    cfg = get_config("internlm2-1.8b", smoke=True).replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    toks = torch.randint(1, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(SEED))
    ref, _ = transformer.prefill(cfg, params, {"tokens": toks}, max_len=32)
    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    got, _ = transformer.prefill(cfg, to_card(params),
                                 {"tokens": toks.to(device)},
                                 max_len=32)
    err = float((got.cpu() - ref).abs().max())
    log(f"reference: SMOKE f32 prefill logits card vs CPU max abs err "
        f"{err:.3e} (atol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"card and CPU logits differ by {err}")


KERNELS = ("row_reduction", "rows_elementwise")
STEP_LAUNCHES = (2, {"cuda": 2}, {k: 1 for k in KERNELS})


def serving_model(device):
    """``internlm2-1.8b`` at full width in bf16, random weights from the
    seed: (config, params) of phases 4 and 7."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.schema import count_params, init_params

    cfg = get_config("internlm2-1.8b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED),
                         device)
    torch.cuda.synchronize()
    log(f"main path: {cfg.name} {cfg.num_layers}L d={cfg.d_model} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} ff={cfg.d_ff} "
        f"V={cfg.vocab_size} {cfg.dtype}, {count_params(params) / 1e9:.3f} B "
        f"params, init {time.perf_counter() - t0:.1f} s")
    return cfg, params


def _captured_admissions(eng) -> list:
    """Wrap an engine's prefill of one admission (``_admit``) to keep, per
    admission, its inputs and its logits.  It adds no synchronization:
    the admissions are timed in a separate pass (``_prefill_profile``)."""
    rec, admit = [], eng._admit

    def captured(tokens, last_index):
        logits, cache = admit(tokens, last_index)
        rec.append({"tokens": tokens, "last": last_index, "logits": logits})
        return logits, cache

    eng._admit = captured
    return rec


def main_path(device, cfg, params):
    """-> (kernel launches of the run, the 12 prompts in submission
    order)."""
    import numpy as np
    import torch

    from repro_torch.core import dispatch
    from repro_torch.models import transformer
    from repro_torch.runtime import ServingRuntime
    from repro_torch.serving.engine import ContinuousEngine

    rt = ServingRuntime(backend="cuda", window=1.0, max_batch=64)
    try:
        eng = ContinuousEngine(cfg, params, capacity=8, max_len=1024,
                               runtime=rt)
        rng = np.random.default_rng(SEED)
        # longest first: FIFO admission at one uniform position packs them
        lens = sorted(rng.integers(32, 201, size=12).tolist(), reverse=True)
        for L in lens:
            eng.submit(rng.integers(1, cfg.vocab_size, size=L), max_new=24)
        torch.cuda.synchronize()
        step_s, per_step = [], []
        dispatch.reset_counters()                # the main path starts here
        t_run = time.perf_counter()
        while eng.stats()["pending"] or eng.stats()["kv"]["live"]:
            t = time.perf_counter()
            with dispatch.count_launches() as c:
                eng.step(temperature=0.8)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            per_step.append((c.delta, c.by_backend, c.by_kernel))
        run_s = time.perf_counter() - t_run
        launches = dispatch.kernel_launch_counts()   # ... and ends here
        flush_s = rt.executor.flush_seconds()
    finally:
        rt.close()
    bad = [(i, s) for i, s in enumerate(per_step) if s != STEP_LAUNCHES]
    if bad:
        raise AssertionError(f"steps not at 2 cuda launches: {bad[:5]}")
    if not all(launches.get(k, 0) > 0 for k in KERNELS):
        raise AssertionError(f"a kernel never launched: {launches}")
    if len(flush_s) != len(step_s):
        raise AssertionError(f"{len(flush_s)} flushes in {len(step_s)} steps")
    res = eng.done
    if len(res) != 12 or any(r.tokens.shape != (24,) for r in res):
        raise AssertionError("not every request got its 24 tokens: "
                             f"{[r.tokens.shape for r in res]}")
    if any(int(t) < 0 or int(t) >= cfg.vocab_size
           for r in res for t in r.tokens):
        raise AssertionError("a sampled token is outside the vocabulary")
    # real logits rows of the model (8 prompts, mixed lengths) through
    # the flush on the kernels and on their plain version
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(8, 64)))
    logits, _ = transformer.prefill(cfg, params, {"tokens": toks.to(device)},
                                    max_len=64)
    X = logits / 0.8
    row_lens = [cfg.vocab_size - cfg.vocab_size // 16 * i for i in range(8)]
    got = rt._run_ragged("softmax.cdf", X, {}, row_lens, backend="cuda")
    ref = rt._run_ragged("softmax.cdf", X, {}, row_lens, backend="eager")
    cdf_err = float((got - ref).abs().max())
    if not (torch.isfinite(X).all() and cdf_err <= 1e-4):
        raise AssertionError(f"model logits' CDF rows differ from the plain "
                             f"version by {cdf_err} (atol 1e-4)")
    tokens = sum(int(r.tokens.shape[0]) for r in res)
    ms = lambda xs: 1e3 * statistics.median(xs)
    log(f"main path: {len(res)} requests x 24 tokens in {len(step_s)} steps, "
        f"{run_s:.2f} s; decode {tokens / run_s:.1f} tokens/s; step ms p50 "
        f"{ms(step_s):.2f}; flush ms p50 {ms(flush_s):.3f}; every step 2 "
        f"cuda launches; kernel launches {launches}; model logits' CDF rows "
        f"vs plain max abs err {cdf_err:.3e}")
    prompts = [r.prompt for r in sorted(res, key=lambda r: r.request_id)]
    breakdown(eng, rng, cfg)
    sample_on_card(cfg, params, rng)
    return launches, prompts


def sample_on_card(cfg, params, rng) -> None:
    """An engine with no runtime samples on the card: two requests at
    temperature 0.8 while any ``Tensor.cpu()`` call raises."""
    import torch

    from repro_torch.serving.engine import ContinuousEngine

    eng = ContinuousEngine(cfg, params, capacity=2, max_len=128)
    for L in (40, 24):
        eng.submit(rng.integers(1, cfg.vocab_size, size=L), max_new=4)
    cpu = torch.Tensor.cpu

    def no_host_copy(self, *a, **k):
        raise AssertionError("the engine copied a tensor to the host")

    torch.Tensor.cpu = no_host_copy
    try:
        res = eng.run(temperature=0.8)
    finally:
        torch.Tensor.cpu = cpu
    if [r.tokens.shape for r in res] != [(4,), (4,)]:
        raise AssertionError(f"no-runtime engine: {[r.tokens for r in res]}")
    log("no-runtime engine: 2 requests x 4 tokens sampled on the card, "
        "no host copy")


def breakdown(eng, rng, cfg, steps: int = 3) -> None:
    """Where a steady decode step's time goes, over 8 live requests
    (after the main path, whose counters are already read): ``steps``
    steps timed without the profiler, then ``steps`` steps under
    ``torch.profiler``.  The idle share is the device's busy time per
    profiled step against the unprofiled step time (the profiler slows
    the host, not the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.runtime = rt = type(eng.runtime)(backend="cuda", window=1.0,
                                         max_batch=64)
    try:
        for _ in range(8):
            eng.submit(rng.integers(1, cfg.vocab_size, size=64),
                       max_new=2 * steps + 4)
        eng.step(temperature=0.8)                # admission (prefills)
        eng.step(temperature=0.8)
        torch.cuda.synchronize()
        plain_s = []
        for _ in range(steps):
            t = time.perf_counter()
            eng.step(temperature=0.8)
            torch.cuda.synchronize()
            plain_s.append(time.perf_counter() - t)
        step_ms = 1e3 * statistics.median(plain_s)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(steps):
                eng.step(temperature=0.8)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t) / steps * 1e3
        if eng.stats()["kv"]["live"] != 8:
            raise AssertionError("the breakdown's steps were not all steady")
        eng.run(temperature=0.8)
    finally:
        rt.close()
    dev = _device_rows(prof, steps)
    busy = sum(t for _, t, _ in dev)
    top = sorted(dev, key=lambda r: -r[1])[:6]
    ported = {k: t for k, t, _ in dev if k.startswith("ragged_softmax")}
    log(f"breakdown ({steps} steady steps of 8 live requests): step "
        f"{step_ms:.2f} ms p50 unprofiled ({prof_ms:.2f} ms under the "
        f"profiler), device busy {busy:.2f} ms/step, idle share "
        f"{1 - busy / step_ms:.1%}, ported kernels {ported}")
    for k, t, n in top:
        log(f"  {t:8.3f} ms/step  x{n:<5d} {k[:90]}")
    log(json.dumps({"breakdown": {
        "step_ms_p50": step_ms, "profiled_step_ms": prof_ms,
        "device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
        "ported_kernels_ms": ported,
        "top": [{"kernel": k[:120], "ms": t, "calls": n} for k, t, n in top]}}))


# ------------------------------------------------------------ phase 7
def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _prefill_profile(cfg, params, rows, reps: int = 3) -> dict:
    """Where one admission's (1, 1024) prefill spends its time, in a pass
    of its own outside any serving loop: the host ms p50 of one
    synchronized ``_admit`` per admission row of ``rows`` ((tokens, last
    index) pairs, after one warm-up call), then the device time per call
    of the first row under ``torch.profiler`` (all kernels, the
    flash-attention kernel's share among them) and the three largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import ContinuousEngine

    eng = ContinuousEngine(cfg, params, capacity=1, max_len=1024)
    tokens, last = rows[0]
    with torch.no_grad():
        eng._admit(tokens, last)
        torch.cuda.synchronize()
        host = []
        for row in rows:
            t = time.perf_counter()
            eng._admit(*row)
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                eng._admit(tokens, last)
            torch.cuda.synchronize()
    dev = _device_rows(prof, reps)
    flash = [t for k, t, _ in dev if "flash_attention" in k]
    top = sorted(dev, key=lambda r: -r[1])[:3]
    return {"host_ms": statistics.median(host),
            "device_ms": sum(t for _, t, _ in dev),
            "flash_kernel_ms": sum(flash),
            "top": [(k[:120], t, n) for k, t, n in top]}


def prefill_path(device, cfg, params, prompts) -> dict:
    """Prefill through the flash-attention kernel (``attention_impl=
    "pallas"``) on both serving paths, with phase 4's weights and prompts:
    (a) ``ContinuousEngine`` (one (1, 1024) row per admission), (b) the
    static ``Engine`` + ``RequestQueue`` in blocks of 4, each left-padded
    to its longest prompt; then (c) the norm path, ``layers.norm(
    use_pallas=True)`` with every RMSNorm weight of the model and
    ``ops.rmsnorm`` with a fused residual.  The per-kernel counts are set
    to 0 just before each path and read just after; the comparisons with
    the plain versions and the reference engines run after that."""
    import numpy as np
    import torch

    from repro_torch.core import dispatch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import layers
    from repro_torch.runtime import ServingRuntime
    from repro_torch.serving.engine import (ContinuousEngine, Engine,
                                            RequestQueue)

    L, steps = cfg.num_layers, 24
    cfg_p = cfg.replace(attention_impl="pallas")
    step_kernels = {"row_reduction": 1, "rows_elementwise": 1}
    # (a) the continuous-batching engine
    captured, flash = [], flash_ops.flash_attention

    def first_call_inputs(q, k, v, **kw):      # layer 0 of the first admission
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone(), kw))
        return flash(q, k, v, **kw)

    rt = ServingRuntime(backend="cuda", window=1.0, max_batch=64)
    try:
        eng = ContinuousEngine(cfg_p, params, capacity=8, max_len=1024,
                               runtime=rt)
        admits = _captured_admissions(eng)
        for p in prompts:
            eng.submit(p, max_new=steps)
        torch.cuda.synchronize()
        flash_ops.flash_attention = first_call_inputs
        per_step = []
        dispatch.reset_counters()            # path (a) starts here
        while eng.stats()["pending"] or eng.stats()["kv"]["live"]:
            admitted = eng.stats()["kv"]["admitted"]
            with dispatch.count_launches() as c:
                eng.step(temperature=0.8)
            torch.cuda.synchronize()
            per_step.append((eng.stats()["kv"]["admitted"] - admitted,
                             c.delta, c.by_backend, c.by_kernel))
        cont = dispatch.kernel_launch_counts()   # ... and ends here
    finally:
        flash_ops.flash_attention = flash
        rt.close()
    for i, (n, delta, by, byk) in enumerate(per_step):
        want = dict(step_kernels, **({"flash_attention": L * n} if n else {}))
        if (delta, by, byk) != (2, {"cuda": 2}, want):
            raise AssertionError(f"continuous step {i} ({n} admissions): "
                                 f"{delta} launches {by} {byk}, want {want}")
    if sum(n for n, *_ in per_step) != len(prompts) or \
            cont.get("flash_attention") != L * len(prompts):
        raise AssertionError(f"admissions did not each launch the kernel "
                             f"{L} times: {cont}")
    res = eng.done
    if len(res) != len(prompts) or any(r.tokens.shape != (steps,)
                                       for r in res):
        raise AssertionError(f"pallas engine: {[r.tokens.shape for r in res]}")
    q, k, v, kw = captured[0]
    qkv_err = _hold("flash on layer 0 of the first admission",
                    flash_ops.flash_attention(q, k, v, **kw),
                    fa.flash_attention_plain(q, k, v, **kw), "bfloat16",
                    "flash")
    first = admits[0]
    readings = {}
    for impl in ("flash_jnp", "naive"):
        ref_eng = ContinuousEngine(cfg.replace(attention_impl=impl), params,
                                   capacity=1, max_len=1024)
        with torch.no_grad():
            readings[impl] = ref_eng._admit(first["tokens"], first["last"])[0]
        del ref_eng
    # the served admission rows, timed in a pass of their own per impl
    rows = [(a["tokens"], a["last"]) for a in admits]
    profiles = {impl: _prefill_profile(cfg.replace(attention_impl=impl),
                                       params, rows)
                for impl in ("pallas", "flash_jnp")}
    pallas_err = _rel_l2(first["logits"], readings["flash_jnp"])
    naive_err = _rel_l2(readings["naive"], readings["flash_jnp"])
    if not pallas_err <= 5e-2:
        raise AssertionError(f"pallas prefill logits differ from flash_jnp's "
                             f"by {pallas_err} (relative L2, limit 5e-2)")
    n_adm = len(per_step)
    pallas_ms = profiles["pallas"]["host_ms"]
    jnp_ms = profiles["flash_jnp"]["host_ms"]
    log(f"prefill (a) ContinuousEngine, pallas: {len(res)} requests x {steps} "
        f"tokens in {n_adm} steps, {L} flash launches per admission "
        f"({cont['flash_attention']} in all), every step 2 cuda launches; "
        f"layer-0 q/k/v kernel vs plain max abs err {qkv_err:.3e}; first "
        f"admission's logits vs flash_jnp relative L2 {pallas_err:.3e} "
        f"(naive vs flash_jnp {naive_err:.3e}); prefill ms p50 per admission "
        f"(its {len(rows)} rows, one synchronized call each, outside the "
        f"serving loop) pallas {pallas_ms:.2f}, flash_jnp {jnp_ms:.2f}")
    for impl, prof in profiles.items():
        log(f"  one (1, 1024) prefill, {impl}: {prof['host_ms']:.2f} ms p50 "
            f"({len(rows)} rows), device busy {prof['device_ms']:.2f} ms, "
            f"flash kernel {prof['flash_kernel_ms']:.3f} ms; top "
            + "; ".join(f"{t:.3f} ms x{n} {k[:60]}" for k, t, n in
                        prof["top"]))
    # (b) the static-batch engine over blocks of 4
    rt = ServingRuntime(backend="cuda", window=1.0, max_batch=64)
    try:
        seng = Engine(cfg_p, params, max_len=232, runtime=rt)
        generate, blocks = seng.generate, []

        def counted(arr, n, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with dispatch.count_launches() as c:
                out = generate(arr, n, **kw)
            blocks.append((arr.shape, dict(c.by_kernel),
                           1e3 * (time.perf_counter() - t)))
            return out

        seng.generate = counted
        queue = RequestQueue()
        for p in prompts:
            queue.submit(p)
        # build the runtime's dense sampler schedule for a (4, V) block
        rt.sample(torch.zeros((4, cfg.vocab_size), device=device),
                  torch.Generator().manual_seed(SEED), 0.8)
        torch.cuda.synchronize()
        dispatch.reset_counters()            # path (b) starts here
        served = queue.run(seng, batch_size=4, steps=steps, temperature=0.8,
                           seed=SEED)
        static = dispatch.kernel_launch_counts()   # ... and ends here
    finally:
        rt.close()
    widths = [max(len(p) for p in prompts[i:i + 4])
              for i in range(0, len(prompts), 4)]
    if [shape for shape, _, _ in blocks] != [(4, w) for w in widths] or \
            any(w % fa.TILE == 0 for w in widths):
        raise AssertionError(f"blocks {[b[0] for b in blocks]}, widths "
                             f"{widths}: each a block of 4 at a width that "
                             f"is no multiple of {fa.TILE}")
    if any(byk.get("flash_attention") != L for _, byk, _ in blocks) or \
            static.get("flash_attention") != L * len(blocks):
        raise AssertionError(f"static blocks' flash launches: "
                             f"{[b[1] for b in blocks]}")
    if len(served) != len(prompts) or any(
            r.tokens.shape != (steps,) or r.padded_len != widths[i // 4]
            for i, r in enumerate(served)):
        raise AssertionError("static engine: " + str(
            [(r.tokens.shape, r.padded_len) for r in served]))
    log(f"prefill (b) Engine + RequestQueue, pallas: {len(blocks)} blocks of "
        f"4 at widths {widths}, {L} flash launches each, kernel launches "
        f"{static}; every request {steps} tokens at its block's width; block "
        f"ms {[round(ms, 1) for _, _, ms in blocks]}")
    # (c) the norm path over the embedded tokens of the first block
    block = np.zeros((4, widths[0]), np.int32)
    for i, p in enumerate(prompts[:4]):
        block[i, widths[0] - len(p):] = p
    x = params["embedding"][torch.from_numpy(block).to(device).long()]
    slot = params["decoder"]["slot_0"]
    weights = [slot[n][l] for l in range(L) for n in ("norm1", "norm2")] + \
        [params["final_norm"]]
    torch.cuda.synchronize()
    dispatch.reset_counters()                # path (c) starts here
    outs = [layers.norm(cfg, {"w": w}, "w", x, use_pallas=True)
            for w in weights]
    fused = rms_ops.rmsnorm(x, weights[-1].to(x.dtype), outs[0],
                            eps=cfg.norm_eps)
    torch.cuda.synchronize()
    norms = dispatch.kernel_launch_counts()  # ... and ends here
    if norms != {"rmsnorm": len(weights) + 1}:
        raise AssertionError(f"norm path launches: {norms}")
    norm_err = max(_hold("norm(use_pallas=True)", o,
                         rmsnorm_ref(x, w.to(x.dtype), eps=cfg.norm_eps),
                         "bfloat16", "rms") for o, w in zip(outs, weights))
    norm_err = max(norm_err, _hold(
        "rmsnorm with a fused residual", fused,
        rmsnorm_ref(x, weights[-1].to(x.dtype), outs[0], eps=cfg.norm_eps),
        "bfloat16", "rms"))
    log(f"norm path: {len(weights)} x layers.norm(use_pallas=True) + 1 fused "
        f"residual over {tuple(x.shape)} bf16, {norms['rmsnorm']} rmsnorm "
        f"launches; vs plain max abs err {norm_err:.3e}")
    log(json.dumps({"prefill": {
        "pallas_prefill_ms_p50": pallas_ms, "flash_jnp_prefill_ms_p50": jnp_ms,
        "admissions": len(admits), "logits_rel_l2_vs_flash_jnp": pallas_err,
        "naive_rel_l2_vs_flash_jnp": naive_err,
        "static_block_ms": [ms for _, _, ms in blocks],
        "static_widths": widths, "profiles": profiles}}))
    return {"flash_attention": {"continuous": cont["flash_attention"],
                                "static": static["flash_attention"]},
            "rmsnorm": {"norm": norms["rmsnorm"]}}


# ------------------------------------------------------------ phase 5
LIB_KERNELS = ("flat_elementwise", "flat_reduction", "scan_pass1",
               "scan_pass2", "row_reduction", "rows_elementwise")


def library_path(device) -> dict:
    """The RTCG library path at sizes users run (the quickstart's
    sections 1-3c on the card), through the entry points a user calls:
    each step's result against the plain version on the same tensors,
    and its launch count against the JAX package's for the same
    expression (the parity tests in tests/test_torch_planner.py and
    tests/test_torch_library.py pin them equal), every launch ``cuda``.
    The per-kernel counts are set to 0 just before the steps and read
    just after; the plain versions run after that."""
    import torch

    import repro_torch.core.array as ga
    from repro_torch.core import (ElementwiseKernel, InclusiveScanKernel,
                                  dispatch)
    from repro_torch.runtime import ServingRuntime

    gen = torch.Generator(device=device).manual_seed(SEED + 2)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    x, y, v = rnd(LIB_N), rnd(LIB_N), rnd(1 << 24, scale=4.0)
    logits, h, cols = rnd(64, MAIN_V, scale=3.0), rnd(4096, 2048), \
        rnd(8192, 2048, scale=3.0)
    w = torch.linspace(0.5, 1.5, 2048, device=device)
    X, Y, V = ga.to_gpu(x), ga.to_gpu(y), ga.to_gpu(v)
    L, H, W, C = (ga.to_gpu(t) for t in (logits, h, w, cols))
    axpy = ElementwiseKernel("float a, float *x, float *y, float *z",
                             "z[i] = x[i] + a*y[i]", name="axpy")
    cumsum = InclusiveScanKernel("float32", "a+b", name="scan_sum")
    rt = ServingRuntime(backend="cuda", window=1.0, max_batch=64)
    plain_rt = ServingRuntime(backend="eager", device=device)
    exprs = {
        "(2*X + 3*Y).sum()": (2 * X + 3 * Y).sum(),
        "X.dot(Y)": X.dot(Y),
        "variance ((v - v.mean())**2).mean()": ((V - V.mean()) ** 2).mean(),
        "softmax(v), 1-D": ga.softmax(V),
        "stable row softmax (64, 92544)": ga.softmax(L, stable=True),
        "rmsnorm (4096, 2048)": H / (((H * H).mean(axis=-1) + 1e-6).sqrt())
        * W,
        "softmax(axis=0) (8192, 2048)": ga.softmax(C, stable=True, axis=0),
    }
    # build every generated kernel of the path first, in parallel
    scheds = [ga.plan_many([e]) for e in exprs.values()] + \
        [ga.plan_many([X.sum(), (X * X).sum()])]
    build([(f"library {p.kernel().name}", p.kernel().name,
            _source(p.kernel()))
           for sc in scheds for p in sc.steps + sc.epilogues],
          "library path")

    def submit_rows(runtime):
        with ThreadPoolExecutor(8) as ex:
            futs = list(ex.map(runtime.submit_softmax, list(logits)))
        runtime.flush()
        return torch.stack([f.result(timeout=120) for f in futs])

    # (label, user call on be=None/the card, plain call, JAX launches,
    #  check kind, scale of the absolute terms for sums)
    steps = [
        ("axpy z = x + a*y, 2**27", lambda be: axpy(2.5, x, y, x, backend=be),
         1, "pointwise", None),
        ("(2*X + 3*Y).sum(), 2**27", "(2*X + 3*Y).sum()", 1, "sum",
         lambda: (2 * x.double() + 3 * y.double()).abs().sum()),
        ("X.dot(Y), 2**27", "X.dot(Y)", 1, "sum",
         lambda: (x.double() * y.double()).abs().sum()),
        ("(sum, sum of squares), 2**27",
         lambda be: torch.stack(ga.plan_many([X.sum(), (X * X).sum()],
                                             backend=be).launch()),
         1, "sum", lambda: torch.stack([x.double().abs().sum(),
                                        (x.double() ** 2).sum()])),
        ("variance, 2**24", "variance ((v - v.mean())**2).mean()", 2, "sum",
         lambda: ((v.double() - v.double().mean()) ** 2).mean()),
        ("softmax(v), 1-D 2**24", "softmax(v), 1-D", 2, "normalized", None),
        ("stable row softmax (64, 92544)", "stable row softmax (64, 92544)",
         2, "normalized", None),
        ("rmsnorm (4096, 2048)", "rmsnorm (4096, 2048)", 2, "normalized",
         None),
        ("softmax(axis=0) (8192, 2048)", "softmax(axis=0) (8192, 2048)", 2,
         "normalized", None),
        ("cumsum, 2**27", lambda be: cumsum(x, backend=be), 1, "sum",
         lambda: torch.cumsum(x.double().abs(), 0)),
        ("runtime.softmax (64, 92544)",
         lambda be: (rt if be is None else plain_rt).softmax(logits), 2,
         "normalized", None),
        ("runtime.rmsnorm (4096, 2048)",
         lambda be: (rt if be is None else plain_rt).rmsnorm(h, w), 2,
         "normalized", None),
        ("runtime.sample (64, 92544) at 0.8",
         lambda be: (rt if be is None else plain_rt).sample(
             logits, torch.Generator().manual_seed(SEED), 0.8), 2, "tokens",
         None),
        ("64 x runtime.submit_softmax (92544), one flush",
         lambda be: submit_rows(rt) if be is None else plain_rt.softmax(
             logits), 2, "normalized", None),
    ]
    steps = [(label, (lambda be, e=exprs[run]: e.evaluate(backend=be).value)
              if isinstance(run, str) else run, n, kind, scale)
             for label, run, n, kind, scale in steps]
    torch.cuda.synchronize()
    flushes0 = rt.executor.stats()["flushes"]
    got, per_step = [], []
    dispatch.reset_counters()                 # the library path starts here
    t0 = time.perf_counter()
    for label, run, _, _, _ in steps:
        with dispatch.count_launches() as c:
            got.append(run(None))
            torch.cuda.synchronize()
        per_step.append((c.delta, c.by_backend))
    run_s = time.perf_counter() - t0
    launches = dispatch.kernel_launch_counts()   # ... and ends here
    if rt.executor.stats()["flushes"] != flushes0 + 1:
        raise AssertionError("the 64 submitted rows did not flush as one")
    rt.close()
    for (label, run, want, kind, scale), out, (n, by) in zip(steps, got,
                                                             per_step):
        if (n, by) != (want, {"cuda": want}):
            raise AssertionError(f"{label}: {n} launches {by}, the JAX "
                                 f"package's schedule is {want} cuda")
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{label}: non-finite output")
        ref = run("eager")
        torch.cuda.synchronize()
        if kind == "tokens":
            if out.dtype != torch.int32 or out.shape != (64,) or \
                    int(out.min()) < 0 or int(out.max()) >= MAIN_V:
                raise AssertionError(f"{label}: bad tokens {out}")
            # a uniform within float32 error of a CDF step may flip a draw
            if int((out != ref).sum()) > 1:
                raise AssertionError(f"{label}: draws differ from the plain "
                                     f"version's: {(out != ref).sum()}")
            err = float((out != ref).sum())
        elif kind == "normalized":
            # softmax / rmsnorm outputs: a float32 normalizer summed in
            # another order (1e-5 relative, as the sum tolerance) plus
            # the exp, sqrt and division roundings
            d = (out.double() - ref.double()).abs()
            if out.shape != ref.shape or not bool(
                    (d <= 2e-5 * ref.double().abs() + 1e-6).all()):
                raise AssertionError(f"{label}: max abs err {float(d.max())}")
            err = float(d.max())
        else:
            err = _close(label, out, ref, kind,
                         scale() if scale is not None else None)
        log(f"  library {label}: {n} cuda launch(es) as in the JAX package, "
            f"max abs err vs plain {err:.3e}")
    missing = [k for k in LIB_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"library path never launched {missing}: "
                             f"{launches}")
    log(f"library path: {len(steps)} steps in {run_s:.2f} s, kernel "
        f"launches {launches}")
    return launches


def _device_rows(prof, per: int) -> list:
    """(kernel name, device ms, launches) per unit of ``per`` from a
    ``torch.profiler`` run."""
    return [(e.key, (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / per,
             e.count // per) for e in prof.key_averages()
            if e.device_type.name == "CUDA"]


#: the kernel of ``_l2_flush``'s write, as torch.profiler names it
L2_FLUSH_KERNEL = "FillFunctor<unsigned char>"


def _l2_flush(device):
    """-> a call that writes a 256 MiB byte buffer, five times the H100's
    50 MB L2, so that the next call reads its inputs from HBM."""
    import torch

    buf = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    return lambda: buf.fill_(1)


def _device_ms(fn, match: "str | None" = None, reps: int = 20,
               flush=None, lead: int = 5, tries: int = 3) -> float:
    """Device time per call, after warm-up, from ``torch.profiler``: the
    kernels whose name contains ``match``, or every kernel the call
    launches.  At the main-path shape a wrapper call costs more host
    time than its kernel, so CUDA events around a loop of calls measure
    the host; the profiler measures the card.  With ``flush`` (see
    `_l2_flush`), it runs before each call and its own kernel is left
    out of the sum.

    The profiler now and then drops the first device events of its
    window, with no warning.  So the window holds ``lead + reps`` calls;
    each kernel's launches per call ``k`` is its count over the calls,
    rounded, and its time per call ``k`` times its mean time per
    recorded launch.  A profile that lost more than ``lead`` calls'
    worth of some kernel's launches is taken again, up to ``tries``
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run = fn if flush is None else (lambda: (flush(), fn()))
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    calls = lead + reps
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        rows = [(key, t, n, round(n / calls))
                for key, t, n in _device_rows(prof, 1)]
        flushed = [k for key, _, _, k in rows if L2_FLUSH_KERNEL in key]
        if rows and all(k >= 1 and n >= k * reps for _, _, n, k in rows) \
                and (flush is None or flushed == [1]):
            break
    else:
        raise AssertionError(f"torch.profiler lost device events in "
                             f"{tries} profiles of {calls} calls: "
                             f"{[(key[:60], n) for key, _, n, _ in rows]}")
    ms = sum(t / n * k for key, t, n, k in rows
             if (flush is None or L2_FLUSH_KERNEL not in key)
             and (match is None or match in key))
    if not ms > 0:
        raise AssertionError(f"the profiler saw no device time for "
                             f"{match or 'the call'}")
    return ms


def _call_ms(fn, reps: int = 50, warmup: int = 10, rounds: int = 5,
             flush=None) -> float:
    """Median over rounds of CUDA-event time per call, after warm-up: the
    wrapper's cost per call, host included.  With ``flush``, it runs
    before each call, outside a pair of events around that one call, and
    the median is over the calls."""
    import torch

    run = fn if flush is None else (lambda: (flush(), fn()))
    for _ in range(warmup):
        run()
    out = []
    for _ in range(rounds):
        if flush is None:
            a, b = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / reps)
            continue
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for a, b in ev:
            flush()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        out += [a.elapsed_time(b) for a, b in ev]
    return statistics.median(out)


def timings(device, launches: dict, lib_launches: dict, worst: dict) -> list:
    import torch
    import torch.nn.functional as F

    from repro_torch.runtime import _ragged_kernels

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    X = torch.randn((MAIN_K, MAIN_V), generator=gen, device=device) * 3.0
    lens = torch.full((MAIN_K,), MAIN_V, dtype=torch.int32, device=device)
    wave, soft_epi = _ragged_kernels("softmax")
    cdf_epi = _ragged_kernels("softmax.cdf")[1]
    rms_wave, rms_epi = _ragged_kernels("rmsnorm")
    r0, r1 = wave(X, backend="eager", row_lens=lens)
    elems, f32 = MAIN_K * MAIN_V, 4
    rows = []
    for name, src, replaces, kernel, run, nbytes, label in (
        ("row_reduction", "src/repro_torch/csrc/row_reduce.cu.j2",
         "src/repro/core/backends/pallas.py:391", wave,
         lambda be: wave(X, backend=be, row_lens=lens),
         # x read once; two (K,) outputs; the (K,) lengths
         elems * f32 + 2 * MAIN_K * f32 + MAIN_K * 4,
         ("softmax_wave.ragged", 1)),
        ("rows_elementwise", "src/repro_torch/csrc/eltwise_rows.cu.j2",
         "src/repro/core/backends/pallas.py:307", cdf_epi,
         lambda be: cdf_epi(r0, r1, X, X, backend=be, row_lens=lens),
         # x read once, the CDF written once; r0, r1 and the lengths
         2 * elems * f32 + 3 * MAIN_K * 4,
         ("softmax_cdf_epi.ragged", 0)),
    ):
        ms = _device_ms(lambda: run("cuda"), match=f"{kernel.name}_kernel")
        call = _call_ms(lambda: run("cuda"))
        plain = _device_ms(lambda: run("eager"))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches.get(name, 0),
                     "launches_by_path": {
                         "serving": launches.get(name, 0),
                         "library": lib_launches.get(name, 0)},
                     "max_abs_err": worst[label], "ms": ms,
                     "plain_ms": plain, "bound_ms": bound,
                     "bound_by": "bytes", "library_ms": None,
                     "call_ms": call})
        log(f"time {name} at K={MAIN_K} V={MAIN_V}: device {ms:.4f} ms "
            f"(wrapper call {call:.4f} ms), plain device {plain:.4f} ms, "
            f"bound {bound:.5f} ms ({nbytes} bytes / 3.35 TB/s)")
    # library yardsticks for the runtime's kernel pairs (never called by
    # the port): the softmax pair against torch.softmax, the rmsnorm pair
    # against torch.nn.functional.rms_norm
    w = torch.linspace(0.5, 1.5, MAIN_V, device=device)
    L = lens.float()
    pairs = [
        ("softmax (wave + epilogue)", "torch.softmax",
         lambda be: soft_epi(*wave(X, backend=be, row_lens=lens), X, X,
                             backend=be, row_lens=lens),
         lambda: torch.softmax(X, dim=-1)),
        ("rmsnorm (wave + epilogue)", "torch.nn.functional.rms_norm",
         lambda be: rms_epi(rms_wave(X, backend=be, row_lens=lens), L, w,
                            1e-6, X, X, backend=be, row_lens=lens),
         lambda: F.rms_norm(X, (MAIN_V,), w, 1e-6)),
    ]
    out = []
    for name, lib, run, libfn in pairs:
        rec = {"name": name, "ms": _device_ms(lambda: run("cuda")),
               "call_ms": _call_ms(lambda: run("cuda")),
               "plain_ms": _device_ms(lambda: run("eager")), "library": lib,
               "library_ms": _device_ms(libfn)}
        out.append(rec)
        log(f"time pair {name}: device {rec['ms']:.4f} ms (calls "
            f"{rec['call_ms']:.4f} ms), plain {rec['plain_ms']:.4f} ms, "
            f"{lib} {rec['library_ms']:.4f} ms")
    log(json.dumps({"pairs": out}))
    return rows


def library_timings(device, lib: dict, launches: dict, serving: dict,
                    worst: dict) -> list:
    """The four library kernels at 2**27 float32 elements (axpy, the sum,
    the ``+`` scan's two passes), plus the whole ``+`` scan, the dot and
    the column sum over (8192, 2048) as extra lines: device ms, call ms,
    plain ms, the bound and the library call that computes the same
    function."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    x = torch.randn(LIB_N, generator=gen, device=device)
    y = torch.randn(LIB_N, generator=gen, device=device)
    cols = torch.randn((8192, 2048), generator=gen, device=device)
    axpy, red_sum, dot = lib["axpy"], lib["sum"], lib["dot"]
    col_sum, cumsum = lib["col_sum"], lib["scan_sum.incl"]
    f32 = 4
    src = "src/repro_torch/csrc/"
    rows, extras = [], []
    for (name, shape, source, replaces, run, match, nbytes, lib_name, libfn,
         err) in (
        ("flat_elementwise", "2**27 f32", "eltwise_flat.cu.j2",
         "pallas.py:268", lambda be: axpy(2.5, x, y, x, backend=be),
         "axpy_kernel", 3 * LIB_N * f32, "torch.add(x, y, alpha=a)",
         lambda: torch.add(x, y, alpha=2.5), "flat_elementwise"),
        ("flat_reduction", "2**27 f32", "reduce_flat.cu.j2", "pallas.py:349",
         lambda be: red_sum(x, y, backend=be), "lib_sum_kernel",
         LIB_N * f32 + f32, "torch.sum", lambda: torch.sum(x),
         "flat_reduction"),
        # the scan's function moves 2 n 4 bytes (read x, write the
        # prefixes); each pass is given its share of that bound, pass 1
        # the read and pass 2 the write (the tile sums it writes and
        # pass 2 reads back are the two-pass design's, not the
        # function's), and the whole call stands beside it as an extra
        ("scan_pass1", "2**27 f32", "scan.cu.j2", "pallas.py:441",
         lambda be: cumsum(x, backend=be), "scan_sum_pass1",
         LIB_N * f32, "torch.cumsum", lambda: torch.cumsum(x, 0), "scan"),
        ("scan_pass2", "2**27 f32", "scan.cu.j2", "pallas.py:446",
         lambda be: cumsum(x, backend=be), "scan_sum_pass2",
         LIB_N * f32, "torch.cumsum", lambda: torch.cumsum(x, 0), "scan"),
        ("scan (+, whole call)", "2**27 f32", "scan.cu.j2",
         "pallas.py:441,446", lambda be: cumsum(x, backend=be), None,
         2 * LIB_N * f32, "torch.cumsum", lambda: torch.cumsum(x, 0), None),
        ("flat_reduction (dot)", "2**27 f32", "reduce_flat.cu.j2",
         "pallas.py:349", lambda be: dot(x, y, backend=be), "lib_dot_kernel",
         2 * LIB_N * f32 + f32, "torch.dot", lambda: torch.dot(x, y), None),
        ("row_reduction (axis=0 sum)", "(8192, 2048) f32", "row_reduce.cu.j2",
         "pallas.py:391", lambda be: col_sum(cols, backend=be),
         "lib_col_sum_kernel", 8192 * 2048 * f32 + 2048 * f32,
         "torch.sum(dim=0)", lambda: torch.sum(cols, 0), None),
    ):
        ms = _device_ms(lambda: run("cuda"), match=match)
        rec = {"name": name, "route": "cuda", "source": src + source,
               "replaces": "src/repro/core/backends/" + replaces,
               "launches": launches.get(name, 0),
               "launches_by_path": {"serving": serving.get(name, 0),
                                    "library": launches.get(name, 0)},
               "max_abs_err": worst[err] if err else None,
               "ms": ms, "plain_ms": _device_ms(lambda: run("eager")),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library": lib_name,
               "library_ms": _device_ms(libfn),
               "call_ms": _call_ms(lambda: run("cuda"), reps=10, rounds=3),
               "shape": shape}
        (rows if err else extras).append(rec)
        log(f"time {name} at {shape}: device {ms:.4f} ms (call "
            f"{rec['call_ms']:.4f} ms), plain device {rec['plain_ms']:.4f} "
            f"ms, bound {rec['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 "
            f"TB/s), {lib_name} {rec['library_ms']:.4f} ms")
    log(json.dumps({"library_extras": extras}))
    return rows


BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor cores (data sheet)


def kernel_timings(device, launches: dict, worst: dict) -> list:
    """The two hand-written kernels: flash attention at the continuous
    engine's prefill shape (1, 16, 8, 1024, 1024, 128) and at S=4096,
    bf16, causal; RMSNorm at (4096, 2048) bf16 with and without a
    residual, and at (16384, 2048).  Device ms (torch.profiler), call ms
    (CUDA events), the plain version's device ms, the bound and a library
    call the port never makes (``scaled_dot_product_attention``,
    ``F.rms_norm``), each with the L2 written over before every call: a
    (4096, 2048) bf16 RMSNorm moves 32 MB, which the 50 MB L2 would
    otherwise keep between calls, below the HBM bound it is held to.
    The first flash and the first RMSNorm case are the ``kernels`` rows;
    the others print as extras."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import rmsnorm as rms
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    bf16, b2 = torch.bfloat16, 2
    cases = []
    for S in (1024, 4096):
        B, H, Hk, D = 1, 16, 8, 128
        q = torch.randn((B, H, S, D), generator=gen, device=device).to(bf16)
        k, v = (torch.randn((B, Hk, S, D), generator=gen,
                            device=device).to(bf16) for _ in range(2))
        nbytes = (2 * B * H + 2 * B * Hk) * S * D * b2      # q, o; k, v
        flops = 4 * B * H * D * S * (S + 1) // 2           # causal pairs
        cases.append((
            "flash_attention", f"(1, 16, 8, {S}, {S}, 128) bf16 causal",
            "flash_attention.cu.j2",
            "src/repro/kernels/flash_attention/flash_attention.py:130",
            lambda q=q, k=k, v=v: flash_ops.flash_attention(q, k, v),
            lambda q=q, k=k, v=v: fa.flash_attention_plain(q, k, v),
            fa.instance(D, bf16, True)[0] + "_kernel", nbytes, flops,
            "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)))
    D = 2048
    w = (1.0 + 0.25 * torch.randn(D, generator=gen, device=device)).to(bf16)
    for R, residual in ((4096, False), (4096, True), (16384, False)):
        x, r = (torch.randn((R, D), generator=gen, device=device).to(bf16)
                for _ in range(2))
        res = r if residual else None
        n_in = 2 if residual else 1
        cases.append((
            "rmsnorm", f"({R}, {D}) bf16" + (" + residual" if residual
                                             else ""),
            "rmsnorm.cu.j2", "src/repro/kernels/rmsnorm/rmsnorm.py:60",
            lambda x=x, res=res: rms_ops.rmsnorm(x, w, res),
            lambda x=x, res=res: rmsnorm_ref(x, w, res),
            rms.instance(bf16, bf16, residual)[0],
            (n_in + 1) * R * D * b2 + D * b2, 0,
            None if residual else "torch.nn.functional.rms_norm",
            None if residual else (lambda x=x: F.rms_norm(x, (D,), w,
                                                          1e-6))))
    flush = _l2_flush(device)
    rows, extras = [], []
    for (name, shape, source, replaces, run, plain, match, nbytes, flops,
         lib_name, libfn) in cases:
        ms = _device_ms(run, match=match, flush=flush)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        rec = {"name": name, "route": "cuda",
               "source": "src/repro_torch/csrc/" + source,
               "replaces": replaces, "launches": sum(launches[name].values()),
               "launches_by_path": launches[name],
               "max_abs_err": worst[name], "ms": ms,
               "plain_ms": _device_ms(plain, flush=flush),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops > t_bytes else "bytes",
               "library": lib_name,
               "library_ms": (_device_ms(libfn, flush=flush) if libfn
                              else None),
               "call_ms": _call_ms(run, reps=20, rounds=3, flush=flush),
               "shape": shape,
               "bytes": nbytes, "flops": flops}
        (extras if any(r["name"] == name for r in rows) else rows).append(rec)
        log(f"time {name} at {shape}: device {ms:.4f} ms (call "
            f"{rec['call_ms']:.4f} ms), plain device {rec['plain_ms']:.4f} "
            f"ms, bound {rec['bound_ms']:.5f} ms ({nbytes} bytes / 3.35 TB/s "
            f"= {t_bytes:.5f}; {flops} flops / 989 TFLOP/s = {t_ops:.5f}), "
            f"{lib_name} {rec['library_ms']} ms")
    log(json.dumps({"kernel_extras": extras}))
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    t0 = time.perf_counter()
    smi = environment()
    lib = library_kernels()
    build_all(lib)
    log("compare: cuda kernels against the eager plain versions")
    worst = compare_all(device)
    lib_worst = compare_library(device, lib)
    log("compare: flash attention and RMSNorm against their plain versions")
    kernel_worst = compare_kernels(device)
    reference_check(device)
    cfg, params = serving_model(device)
    launches, prompts = main_path(device, cfg, params)
    kernel_launches = prefill_path(device, cfg, params, prompts)
    del params
    lib_launches = library_path(device)
    rows = timings(device, launches, lib_launches, worst) + \
        library_timings(device, lib, lib_launches, launches, lib_worst) + \
        kernel_timings(device, kernel_launches, kernel_worst)
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
