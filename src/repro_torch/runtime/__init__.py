"""Serving runtime — the coalescing executor over the ragged row families.

The port of the JAX package's ``runtime/__init__.py`` for the serving
path: a `ServingRuntime` with a *pinned* backend (``cuda`` on the card,
``eager`` on the CPU) and its `CoalescingExecutor`.  Independent
single-row requests — one sampler row per live decode slot — coalesce
into ONE ragged flush: a row-segmented reduction wave plus one fused
2-D epilogue, 2 generated launches for the whole batch, whatever the
mix of row lengths.

    rt = ServingRuntime(backend="cuda")             # the card
    futs = [rt.submit_sample(row, gen, temperature=0.8) for row in rows]
    rt.flush()
    tokens = [f.result() for f in futs]             # one 2-launch flush

Families: ``softmax.cdf`` (the sampler: softmax with its inverse-CDF
``cumsumf`` fused into the epilogue launch), ``softmax`` and
``rmsnorm``, all ragged.  What waits for its ROADMAP Queue 1 item raises
`NotImplementedError`: ``backend="auto"`` and the router, the warm-start
manifest, the fault harness (item 2), and the dense planner families
(item 1).
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import backends as _backends
from repro_torch.core import dispatch
from repro_torch.core.platform import resolve_device
from repro_torch.runtime.executor import CoalescingExecutor, RuntimeFuture
from repro_torch.runtime.kvcache import FleetOverloadError, RequestsCache

_PLANNER = ("the dense runtime families need the fusion planner, ported "
            "with ROADMAP Queue 1 item 1")


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
        the executor's flush target.  Only the ragged schedules are
        ported: ``row_lens`` (one length per row) is required."""
        if row_lens is None:
            raise NotImplementedError(_PLANNER)
        return self._run_ragged(family, X, shared, row_lens, backend=backend)

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

    # -- dense (planner) calls: not in this slice ------------------------
    def softmax(self, x, stable: bool = True, backend=None, axis: int = -1):
        raise NotImplementedError(_PLANNER)

    def rmsnorm(self, x, w, eps: float = 1e-6, backend=None):
        raise NotImplementedError(_PLANNER)

    def sample(self, logits, generator, temperature: float = 1.0,
               backend=None):
        raise NotImplementedError(_PLANNER)

    def warmup(self) -> dict:
        raise NotImplementedError("the warm-start manifest is ported with "
                                  "ROADMAP Queue 1 item 2")

    # -- coalescing single-row submissions -------------------------------
    def _row(self, row) -> torch.Tensor:
        return torch.as_tensor(row).to(self.device)

    def submit_softmax(self, row, stable: bool = True,
                       deadline: "float | None" = None,
                       ragged: bool = False) -> RuntimeFuture:
        """Queue one softmax row; with ``ragged=True`` it coalesces with
        rows of *any* length (rows pad to the flush max and the kernels
        mask per row), so mixed-length traffic still batches."""
        if not ragged or not stable:
            raise NotImplementedError(_PLANNER)
        return self.executor.submit("softmax", self._row(row),
                                    shared={"stable": stable},
                                    key_extra=(bool(stable),),
                                    deadline=deadline, ragged=True)

    def submit_rmsnorm(self, row, w, eps: float = 1e-6,
                       deadline: "float | None" = None,
                       ragged: bool = False) -> RuntimeFuture:
        """Queue one rmsnorm row; coalesces with rows sharing the SAME
        weight vector (identity) and eps."""
        if not ragged:
            raise NotImplementedError(_PLANNER)
        return self.executor.submit(
            "rmsnorm", self._row(row).to(torch.float32),
            shared={"w": w, "eps": eps}, key_extra=(id(w), float(eps)),
            deadline=deadline, ragged=True)

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
