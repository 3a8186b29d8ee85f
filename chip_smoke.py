#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: the card's name and power limit (``nvidia-smi``), torch,
   CUDA, ``nvcc --version``, jinja2;
2. build: renders every CUDA kernel instance of the serving path and the
   ragged runtime families from the templates under
   ``src/repro_torch/csrc`` and compiles them with ``nvcc`` for
   ``sm_90a``, one ``nvcc`` per source, all started together;
3. every instance against its plain version (the ``eager`` backend) on
   the same card tensors, K in {1, 3, 8, 64} x N in {1, 1023, 92544,
   131073} with mixed row lengths;
4. the main path: ``internlm2-1.8b`` at full width in bf16 (random
   weights from a seed) served by ``ContinuousEngine(capacity=8,
   max_len=1024)`` with ``ServingRuntime(backend="cuda")``: 12 prompts
   of 32-200 tokens, 24 new tokens each at temperature 0.8; every step
   must be exactly 2 launches, both ``cuda``, one of each kernel; real
   model logits rows go through the flush on the kernels and on their
   plain version; then 3 steady steps of 8 live requests are timed, and
   3 more under ``torch.profiler`` say where a step's time goes; an
   engine without a runtime samples on the card, with no host copy;
5. times at the main-path shape (K=8, V=92544): each kernel's device
   time (``torch.profiler``) and its wrapper's time per call (CUDA
   events), its plain version, its bound, and library yardsticks the
   port never calls.

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


def build_all() -> None:
    from repro_torch.core.rtcg import CudaSourceModule

    jobs = [(label, k.name, k.render(1, 128, backend="cuda", ragged=ragged))
            for label, k, ragged in instances()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        mods = list(ex.map(lambda j: CudaSourceModule.load(j[2], name=j[1]),
                           jobs))
    log(f"build: {len(jobs)} instances, {len({m.path for m in mods})} "
        f"sources, {time.perf_counter() - t0:.2f} s wall")
    for (label, _, _), m in zip(jobs, mods):
        usage = [ln.split("ptxas info    : ")[-1] for ln in
                 m.build_log.splitlines() if "Used" in ln]
        log(f"  {label}: {m.path.relative_to(ROOT) if m.path.is_relative_to(ROOT) else m.path}"
            f" compiled={m.compiled} {' '.join(usage)}")


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

    gen = torch.Generator(device=device).manual_seed(SEED)
    worst: dict = {}
    for K in (1, 3, 8, 64):
        for N in (1, 1023, 92544, 131073):
            X, lens = _inputs(K, N, gen, device)
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


def main_path(device) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core import dispatch
    from repro_torch.models import transformer
    from repro_torch.models.schema import count_params, init_params
    from repro_torch.runtime import ServingRuntime
    from repro_torch.serving.engine import ContinuousEngine

    cfg = get_config("internlm2-1.8b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED),
                         device)
    torch.cuda.synchronize()
    log(f"main path: {cfg.name} {cfg.num_layers}L d={cfg.d_model} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} ff={cfg.d_ff} "
        f"V={cfg.vocab_size} {cfg.dtype}, {count_params(params) / 1e9:.3f} B "
        f"params, init {time.perf_counter() - t0:.1f} s")
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
    breakdown(eng, rng, cfg)
    sample_on_card(cfg, params, rng)
    return launches


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


# ------------------------------------------------------------ phase 5
def _device_rows(prof, per: int) -> list:
    """(kernel name, device ms, launches) per unit of ``per`` from a
    ``torch.profiler`` run."""
    return [(e.key, (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / per,
             e.count // per) for e in prof.key_averages()
            if e.device_type.name == "CUDA"]


def _device_ms(fn, match: "str | None" = None, reps: int = 20) -> float:
    """Device time per call, after warm-up, from ``torch.profiler``: the
    kernels whose name contains ``match``, or every kernel the call
    launches.  At the main-path shape a wrapper call costs more host
    time than its kernel, so CUDA events around a loop of calls measure
    the host; the profiler measures the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = sum(t for k, t, _ in _device_rows(prof, reps)
             if match is None or match in k)
    if not ms > 0:
        raise AssertionError(f"the profiler saw no device time for "
                             f"{match or 'the call'}")
    return ms


def _call_ms(fn, reps: int = 50, warmup: int = 10, rounds: int = 5) -> float:
    """Median over rounds of CUDA-event time per call, after warm-up: the
    wrapper's cost per call, host included."""
    import torch

    for _ in range(warmup):
        fn()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def timings(device, launches: dict, worst: dict) -> list:
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
    build_all()
    log("compare: cuda kernels against the eager plain versions")
    worst = compare_all(device)
    reference_check(device)
    launches = main_path(device)
    rows = timings(device, launches, worst)
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
