"""Serving runtime — the coalescing executor over the kernel families.

The port of the JAX package's ``runtime/__init__.py``: a
`ServingRuntime` with a *pinned* backend (``cuda`` on the card,
``eager`` on the CPU) and its `CoalescingExecutor`.  Independent
single-row requests — one sampler row per live decode slot — coalesce
into ONE flush: a row-segmented reduction wave plus one fused 2-D
epilogue, 2 generated launches for the whole batch.

    rt = ServingRuntime(backend="cuda")             # the card
    futs = [rt.submit_sample(row, gen, temperature=0.8) for row in rows]
    rt.flush()
    tokens = [f.result() for f in futs]             # one 2-launch flush

Families, each 2 launches per flush:

  * ragged (rows of any length, each masked to its own length):
    ``softmax.cdf`` (the sampler: softmax with its inverse-CDF
    ``cumsumf`` fused into the epilogue launch), ``softmax``,
    ``rmsnorm``;
  * dense, through the fusion planner (`repro_torch.core.array`):
    ``softmax`` (stable or not), ``softmax.axis0`` (column softmax over
    the IR's transposed domain) and ``rmsnorm`` — what
    `ServingRuntime.softmax` / `rmsnorm` / `sample` and the non-ragged
    ``submit_softmax`` / ``submit_rmsnorm`` run.

What waits for ROADMAP Queue 1 item 2 raises `NotImplementedError`:
``backend="auto"`` and the router, the warm-start manifest, the fault
harness.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import backends as _backends
from repro_torch.core import dispatch
from repro_torch.core.platform import canonical_dtype, resolve_device
from repro_torch.runtime.executor import CoalescingExecutor, RuntimeFuture
from repro_torch.runtime.kvcache import FleetOverloadError, RequestsCache

class ServingRuntime:
    """Executor + pinned backend: the serving layer of the port.

    ``device`` defaults to the card (``cuda``) and raises when there is
    none; pass ``device="cpu"`` to serve on the CPU.  ``backend``
    defaults to ``REPRO_TORCH_BACKEND``, else to the device's backend
    (``cuda`` or ``eager``).  ``window``/``max_batch`` shape the
    executor's micro-batch flush policy.
    """

    def __init__(self, backend: "str | None" = None, window: float = 0.002,
                 max_batch: int = 64, device=None, router=None,
                 manifest=None):
        if router is not None or manifest is not None or backend == "auto":
            raise NotImplementedError(
                "the latency router (backend='auto') and the warm-start "
                "manifest are ported with ROADMAP Queue 1 item 2")
        self.device = resolve_device(device)
        name = (backend or _backends.active_backend_name()
                or _backends.backend_for_device(self.device))
        self.backend = _backends.get_backend(name).name
        if self.backend == "cuda" and self.device.type != "cuda":
            raise ValueError("backend 'cuda' serves CUDA tensors; got "
                             f"device {self.device}")
        self.executor = CoalescingExecutor(self, window=window,
                                           max_batch=max_batch)

    def _run_batch(self, family: str, X, shared: dict,
                   backend: "str | None" = None, row_lens=None):
        """Run one fused row schedule over a stacked ``(K, N)`` operand —
        the executor's flush target.  With ``row_lens`` (one length per
        row) the schedule runs the *ragged* kernel pair; without, the
        dense family goes through the fusion planner: one segmented
        reduction wave plus one fused epilogue."""
        if row_lens is not None:
            return self._run_ragged(family, X, shared, row_lens,
                                    backend=backend)
        from repro_torch.core import array as ga

        be = backend or self.backend
        X = torch.as_tensor(X).to(self.device)
        if family == "softmax.cdf":
            raise ValueError("family 'softmax.cdf' is ragged-only "
                             "(pass row_lens=)")
        if family in ("softmax", "softmax.axis0"):
            # the plan computes in float32 whatever the input's type (exp
            # promotes), so float32 operands change no result and let the
            # CUDA kernels serve bf16 rows too
            axis = 0 if family == "softmax.axis0" else -1
            return ga.softmax(ga.RTCGArray(X.to(torch.float32)),
                              stable=bool(shared.get("stable", True)),
                              axis=axis).evaluate(backend=be).value
        if family == "rmsnorm":
            w = torch.as_tensor(shared["w"]).to(self.device, X.dtype)
            eps = float(shared.get("eps", 1e-6))
            Xa, W = ga.RTCGArray(X), ga.RTCGArray(w)
            return (Xa / (((Xa * Xa).mean(axis=-1) + eps).sqrt())
                    * W).evaluate(backend=be).value
        raise ValueError(f"unknown runtime family {family!r} "
                         "(softmax | softmax.axis0 | rmsnorm)")

    def _run_ragged(self, family: str, X, shared: dict, row_lens,
                    backend: "str | None" = None):
        """One *ragged* 2-launch flush: a row-segmented reduction wave
        over the per-row lengths, plus a fused 2-D epilogue masked to the
        same lengths.  Rows shorter than the flush width contribute only
        their own elements; the padding columns come back zeroed.

        Families: ``softmax`` (probabilities), ``softmax.cdf`` (the
        sampler epilogue — the inverse-CDF cumulative sum fuses into the
        SAME epilogue launch via ``cumsumf``), ``rmsnorm`` (sum-of-squares
        wave normalized by each row's true length)."""
        be = backend or self.backend
        b, n = int(X.shape[0]), int(X.shape[-1])
        X32 = X.to(self.device, torch.float32)
        lens = torch.as_tensor(row_lens, dtype=torch.int32).reshape(-1)
        if int(lens.shape[0]) != b:
            raise ValueError(f"row_lens has {int(lens.shape[0])} entries "
                             f"for {b} rows")
        lens = lens.to(self.device)
        if family in ("softmax", "softmax.cdf"):
            wave, epilogue = _ragged_kernels(family)
            r0, r1 = wave(X32, backend=be, row_lens=lens)
            return epilogue(r0, r1, X32, X32, backend=be, row_lens=lens)
        if family == "rmsnorm":
            wave, epilogue = _ragged_kernels("rmsnorm")
            w = torch.as_tensor(shared["w"]).to(self.device,
                                                torch.float32).reshape(-1)
            eps = float(shared.get("eps", 1e-6))
            # bind the shared weight at the flush width: row i reads
            # w[:len_i] (columns align), and masked columns never read w
            if int(w.shape[0]) >= n:
                w = w[:n]
            else:
                w = F.pad(w, (0, n - int(w.shape[0])), value=1.0)
            L = lens.to(torch.float32)  # true-length mean, not bucket mean
            r0 = wave(X32, backend=be, row_lens=lens)
            return epilogue(r0, L, w, eps, X32, X32, backend=be,
                            row_lens=lens)
        raise ValueError(f"unknown ragged family {family!r} "
                         "(softmax | softmax.cdf | rmsnorm)")

    # -- direct (already-batched) calls ----------------------------------
    def _operand(self, x) -> torch.Tensor:
        """``x`` on the runtime's device, in its dtype under the JAX
        x64-off rule (float64 -> float32, int64 -> int32)."""
        X = torch.as_tensor(x).to(self.device)
        return X.to(canonical_dtype(X.dtype))

    def softmax(self, x, stable: bool = True,
                backend: "str | None" = None, axis: int = -1):
        """Softmax over a whole operand (any batch shape): ONE 2-launch
        row schedule.  ``axis=0`` normalizes the *columns* of a 2-D
        operand (the ``softmax.axis0`` family) — the same schedule over
        the kernel IR's transposed domain."""
        X = self._operand(x)
        if axis in (0, -2) and X.ndim >= 2:
            if X.ndim != 2:
                raise ValueError("axis=0 softmax requires a 2-D operand")
            out = self._run_batch("softmax.axis0", X, {"stable": stable},
                                  backend=backend)
            return out.reshape(X.shape).to(X.dtype)
        rows = X.reshape(-1, X.shape[-1]) if X.ndim >= 2 else X.reshape(1, -1)
        out = self._run_batch("softmax", rows, {"stable": stable},
                              backend=backend)
        return out.reshape(X.shape).to(X.dtype)

    def rmsnorm(self, x, w, eps: float = 1e-6,
                backend: "str | None" = None):
        """Planner RMSNorm in float32 (like `models.layers.rtcg_rmsnorm`),
        cast back to the input dtype."""
        X = self._operand(x)
        rows = X.reshape(-1, X.shape[-1]).to(torch.float32)
        w32 = torch.as_tensor(w).to(self.device, torch.float32)
        out = self._run_batch("rmsnorm", rows, {"w": w32, "eps": eps},
                              backend=backend)
        return out.reshape(X.shape).to(X.dtype)

    def sample(self, logits, generator: "torch.Generator | None",
               temperature: float = 1.0, backend: "str | None" = None):
        """Temperature sampling with the softmax run by the runtime: the
        probabilities of the whole ``(B, V)`` block come from ONE 2-launch
        schedule; the draw is one uniform per row from ``generator`` (a
        CPU `torch.Generator`, in place of the JAX package's key) and a
        float64 host inverse-CDF, as in the JAX package.  Temperature 0
        is the argmax."""
        L = self._operand(logits)
        if temperature == 0.0:
            return torch.argmax(L, dim=-1).to(torch.int32)
        probs = self.softmax(L / float(temperature), stable=True,
                             backend=backend)
        rows = probs.reshape(-1, probs.shape[-1]).cpu().numpy() \
            .astype(np.float64)
        cum = np.cumsum(rows, axis=-1)
        u = torch.rand((rows.shape[0],), generator=generator,
                       dtype=torch.float64).numpy() * cum[:, -1]
        toks = np.minimum((cum < u[:, None]).sum(axis=-1),
                          rows.shape[-1] - 1).astype(np.int32)
        return torch.as_tensor(toks.reshape(tuple(L.shape[:-1])),
                               device=self.device)

    def warmup(self) -> dict:
        raise NotImplementedError("the warm-start manifest is ported with "
                                  "ROADMAP Queue 1 item 2")

    # -- coalescing single-row submissions -------------------------------
    def _row(self, row) -> torch.Tensor:
        return torch.as_tensor(row).to(self.device)

    def submit_softmax(self, row, stable: bool = True,
                       deadline: "float | None" = None,
                       ragged: bool = False) -> RuntimeFuture:
        """Queue one softmax row; same-length rows inside the window
        flush as ONE ``(K, N)`` 2-launch schedule.  With ``ragged=True``
        it coalesces with rows of *any* length (rows pad to the flush max
        and the kernels mask per row), so mixed-length traffic still
        batches."""
        return self.executor.submit("softmax", self._row(row),
                                    shared={"stable": stable},
                                    key_extra=(bool(stable),),
                                    deadline=deadline, ragged=ragged)

    def submit_rmsnorm(self, row, w, eps: float = 1e-6,
                       deadline: "float | None" = None,
                       ragged: bool = False) -> RuntimeFuture:
        """Queue one rmsnorm row; coalesces with rows sharing the SAME
        weight vector (identity) and eps."""
        return self.executor.submit(
            "rmsnorm", self._row(row).to(torch.float32),
            shared={"w": w, "eps": eps}, key_extra=(id(w), float(eps)),
            deadline=deadline, ragged=ragged)

    def submit_sample(self, logits_row, generator: "torch.Generator | None",
                      temperature: float = 1.0,
                      deadline: "float | None" = None) -> RuntimeFuture:
        """Queue one sampler request: the row joins the ragged
        ``softmax.cdf`` micro-batch (scaled by its temperature at submit
        so the batch stays homogeneous) — mixed lengths coalesce into ONE
        flush, and the inverse-CDF cumsum runs fused inside the flush's
        epilogue launch.  The per-request post-step is one host
        ``searchsorted`` on this request's CDF row, with a uniform drawn
        from ``generator`` (a CPU `torch.Generator`)."""
        row = self._row(logits_row) / float(max(temperature, 1e-8))
        return self.executor.submit(
            "softmax.cdf", row, shared={}, key_extra=(True,),
            post=lambda cdf_row: _draw_cdf(cdf_row, generator),
            deadline=deadline, ragged=True)

    # -- lifecycle / introspection ---------------------------------------
    def stats(self) -> dict:
        return {"backend": self.backend, "device": str(self.device),
                "executor": self.executor.stats(),
                "dispatch": dispatch.stats()}

    def flush(self, wait: bool = True) -> None:
        self.executor.flush(wait=wait)

    def close(self) -> None:
        self.executor.close()


_RAGGED_LOCK = threading.Lock()
_RAGGED_KERNELS: dict = {}


def _ragged_kernels(family: str):
    """Module-cached (wave, epilogue) kernel pair for one ragged family.

    Built once per process and shared by every runtime instance — the
    kernel objects only *describe* the computation; compiled drivers
    live in the process-wide dispatch LRU keyed per backend/bucket."""
    from repro_torch.core.elementwise import ElementwiseKernel
    from repro_torch.core.platform import BroadcastArg, ScalarArg, VectorArg
    from repro_torch.core.reduction import ReductionKernel

    with _RAGGED_LOCK:
        pair = _RAGGED_KERNELS.get(family)
        if pair is not None:
            return pair
        f32 = torch.float32
        if family in ("softmax", "softmax.cdf"):
            wave = _RAGGED_KERNELS.get("_softmax_wave")
            if wave is None:
                # stable two-accumulator wave: row max + shifted exp sum
                wave = ReductionKernel(
                    [f32, f32], ["-3.4e38", "0"],
                    ["fmaxf(a, b)", "a + b"],
                    ["x[i]", "expf(x[i] - _acc0)"],
                    "float *x", axis=-1, name="ragged_softmax_wave")
                _RAGGED_KERNELS["_softmax_wave"] = wave
            op = ("out[i] = cumsumf(expf(x[i] - r0) / r1)"
                  if family == "softmax.cdf"
                  else "out[i] = expf(x[i] - r0) / r1")
            epilogue = ElementwiseKernel(
                [BroadcastArg(f32, "r0", "row"), BroadcastArg(f32, "r1", "row"),
                 VectorArg(f32, "x"), VectorArg(f32, "out")],
                op, name=f"ragged_{family.replace('.', '_')}_epi",
                layout="rows")
        elif family == "rmsnorm":
            wave = ReductionKernel(
                f32, "0", "a + b", "x[i] * x[i]",
                "float *x", axis=-1, name="ragged_rmsnorm_wave")
            epilogue = ElementwiseKernel(
                [BroadcastArg(f32, "r0", "row"), BroadcastArg(f32, "L", "row"),
                 BroadcastArg(f32, "w", "col"), ScalarArg(f32, "eps"),
                 VectorArg(f32, "x"), VectorArg(f32, "out")],
                "out[i] = x[i] / sqrtf(r0 / L + eps) * w[i]",
                name="ragged_rmsnorm_epi", layout="rows")
        else:
            raise ValueError(f"unknown ragged family {family!r}")
        pair = (wave, epilogue)
        _RAGGED_KERNELS[family] = pair
        return pair


def _draw_cdf(cdf_row, generator: "torch.Generator | None" = None, *,
              u: "float | None" = None) -> int:
    """Categorical draw from one *cumulative* probability row (the fused
    ``softmax.cdf`` epilogue output): the cumsum already ran on device
    inside the flush, so the host post-step is a single float64
    ``searchsorted`` of ``u * cum[-1]`` (residual-mass normalized).
    ``u`` is drawn uniform in [0, 1) from ``generator`` unless given."""
    cum = np.asarray(torch.as_tensor(cdf_row).cpu(), np.float64)
    if u is None:
        u = float(torch.rand((), generator=generator, dtype=torch.float64))
    return min(int(np.searchsorted(cum, u * cum[-1], side="right")),
               cum.shape[-1] - 1)


__all__ = [
    "ServingRuntime", "CoalescingExecutor", "RuntimeFuture",
    "FleetOverloadError", "RequestsCache",
]
