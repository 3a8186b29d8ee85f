"""Request-coalescing executor — micro-batch concurrent single-row work.

Request traffic arrives as *independent* single-row calls (a sampler
softmax over one logits row per request).  The row-segmented kernels
execute a whole ``(K, N)`` batch in the same 2 launches (one reduction
wave + one fused 2-D epilogue), so this executor batches *across*
requests:

  * `submit` enqueues a row into the micro-batch forming for its
    coalescing key — ``(family, row length, dtype, family params)``, or
    with ``ragged=True`` ``(family, dtype, params)`` whatever the length
    — and returns a `RuntimeFuture`;
  * a batch **flushes** when it reaches ``max_batch`` rows or its
    ``window`` (seconds from its first row) expires, whichever is first;
  * a flush stacks the rows into one ``(K, N)`` operand (ragged rows pad
    to the longest), runs the family's row schedule ONCE through the
    owning `ServingRuntime`, then scatters row results back to their
    futures — K requests, 2 launches.  A failed flush falls back to
    bounded per-row retries, so one bad request errors only its own
    future.

The port of the JAX package's ``runtime/executor.py`` without its spans
and fault probes (those come with ROADMAP Queue 1 items 2 and 3).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch

#: attempts per row after a failed flush (the JAX package reads
#: REPRO_RETRY_MAX through its fault harness; the port fixes its default)
ROW_ATTEMPTS = 6

#: flush durations kept for `CoalescingExecutor.flush_seconds`
FLUSH_HISTORY = 1024


class RuntimeFuture:
    """Single-assignment result slot handed back by `submit`.

    First writer wins: once a result or error lands, later writes are
    ignored — so `close()` can fail a stuck request and a late worker
    completion is dropped instead of clobbering the reported error."""

    __slots__ = ("_event", "_value", "_error", "_family", "_n")

    def __init__(self, family: str = "?", n: int = 0):
        self._event = threading.Event()
        self._value: Any = None
        self._error: "BaseException | None" = None
        self._family = family
        self._n = n

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: "float | None" = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"runtime request still pending after {timeout}s "
                f"(family={self._family!r}, row_length={self._n})")
        if self._error is not None:
            raise self._error
        return self._value

    def _set(self, value: Any) -> None:
        if self._event.is_set():
            return
        self._value = value
        self._event.set()

    def _set_error(self, exc: BaseException) -> None:
        if self._event.is_set():
            return
        self._error = exc
        self._event.set()


class _Batch:
    __slots__ = ("family", "shared", "deadline", "rows", "posts", "futures",
                 "deadlines", "budgets", "submits", "ragged")

    def __init__(self, family: str, shared: dict, deadline: float,
                 ragged: bool = False):
        self.family = family
        self.shared = shared
        self.deadline = deadline
        self.ragged = ragged            # rows may differ in length
        self.rows: list = []
        self.posts: list = []
        self.futures: list[RuntimeFuture] = []
        self.deadlines: list = []       # per-request absolute deadlines
        self.budgets: list = []         # the raw deadline= seconds (report)
        self.submits: list = []         # submit timestamps (elapsed report)

    def absorb(self, other: "_Batch", limit: int) -> int:
        """Move up to ``limit`` queued requests from ``other`` into this
        batch (FIFO) — the flush-window drain.  Returns rows moved."""
        take = max(0, min(limit, len(other.rows)))
        for name in ("rows", "posts", "futures", "deadlines", "budgets",
                     "submits"):
            src = getattr(other, name)
            getattr(self, name).extend(src[:take])
            del src[:take]
        return take


class CoalescingExecutor:
    """Micro-batch window over single-row requests (one worker thread).

    ``runtime`` is the owning `ServingRuntime` — flushes call its
    ``_run_batch``.  ``window`` is the maximum seconds a request waits
    for co-travellers; ``max_batch`` flushes a batch early the moment it
    fills.
    """

    def __init__(self, runtime, window: float = 0.002, max_batch: int = 64):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._runtime = runtime
        self.window = float(window)
        self.max_batch = int(max_batch)
        self._cv = threading.Condition()
        self._batches: dict = {}      # coalescing key -> _Batch
        self._inflight = 0
        self._inflight_batches: list = []  # popped but not yet resolved
        self._closed = False
        self._thread: "threading.Thread | None" = None
        # counters (under _cv): the coalesce-factor bookkeeping
        self._requests = 0
        self._flushes = 0
        self._launches = 0
        self._max_coalesce = 0
        self._batch_retries = 0       # flushes that fell back to per-row
        self._isolated_rows = 0       # rows re-run individually
        self._row_retries = 0         # individual row attempts beyond first
        self._row_failures = 0        # futures failed after isolation
        self._window_flushes = 0      # flushed below max_batch (window/close)
        self._full_flushes = 0        # flushed at max_batch
        self._drained_rows = 0        # rows pulled into a due batch at flush
        self._flush_s: deque = deque(maxlen=FLUSH_HISTORY)

    # -- submission ------------------------------------------------------
    def submit(self, family: str, row, *, shared: "dict | None" = None,
               key_extra: tuple = (), post: "Callable | None" = None,
               deadline: "float | None" = None,
               ragged: bool = False) -> RuntimeFuture:
        """Queue one row for ``family``; rows sharing the coalescing key
        inside one window flush as a single ``(K, N)`` schedule.
        ``post(row_result)`` runs on this request's slice of the batch
        output, on the host (the sampler's per-request categorical
        draw).  ``deadline`` (seconds from now) bounds this request's
        share of any per-row retry budget after a failed flush.
        ``ragged`` drops the row *length* from the coalescing key: the
        future resolves with exactly its own ``len(row)`` prefix."""
        if row.ndim != 1:
            raise ValueError(
                f"submit coalesces single rows; got shape {tuple(row.shape)} "
                "(batched operands go through the runtime directly)")
        fut = RuntimeFuture(family, int(row.shape[0]))
        lkey = "R" if ragged else int(row.shape[0])
        key = (family, lkey, str(row.dtype)) + tuple(key_extra)
        with self._cv:
            if self._closed:
                raise RuntimeError("executor is closed")
            batch = self._batches.get(key)
            if batch is None:
                batch = self._batches[key] = _Batch(
                    family, dict(shared or {}),
                    time.monotonic() + self.window, ragged=ragged)
            batch.rows.append(row)
            batch.posts.append(post)
            batch.futures.append(fut)
            now = time.monotonic()
            batch.deadlines.append(
                None if deadline is None else now + deadline)
            batch.budgets.append(deadline)
            batch.submits.append(now)
            self._requests += 1
            self._ensure_thread()
            self._cv.notify_all()
        return fut

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="repro-torch-runtime-flusher",
                daemon=True)
            self._thread.start()

    # -- the flush loop --------------------------------------------------
    def _due(self, now: float) -> list:
        return [k for k, b in self._batches.items()
                if self._closed or b.deadline <= now
                or len(b.rows) >= self.max_batch]

    def _loop(self) -> None:
        while True:
            with self._cv:
                now = time.monotonic()
                due = self._due(now)
                if not due:
                    if self._closed:
                        return
                    timeout = None
                    if self._batches:
                        timeout = max(0.0, min(
                            b.deadline for b in self._batches.values()) - now)
                    self._cv.wait(timeout)
                    continue
                batches = [(k, self._batches.pop(k)) for k in due]
                self._inflight += len(batches)
                self._inflight_batches.extend(b for _, b in batches)
            try:
                for k, b in batches:
                    self._drain_into(k, b)
                    self._flush_batch(b)
            finally:
                with self._cv:
                    self._inflight -= len(batches)
                    for _, b in batches:
                        try:
                            self._inflight_batches.remove(b)
                        except ValueError:
                            pass
                    self._cv.notify_all()

    def _drain_into(self, key, batch: _Batch) -> None:
        """Pull same-key rows that arrived while this batch waited to
        flush into it (up to ``max_batch``), so a continuous request
        stream rides the earliest flush."""
        with self._cv:
            queued = self._batches.get(key)
            if queued is None:
                return
            moved = batch.absorb(queued, self.max_batch - len(batch.rows))
            self._drained_rows += moved
            if not queued.rows:
                del self._batches[key]

    @staticmethod
    def _scatter(batch: _Batch, out, lens) -> None:
        """Resolve each future with its row (its true-length prefix when
        ragged); post steps run on ONE host copy of the batch output.  A
        failing post fails only its own future."""
        host = out.cpu() if any(p is not None for p in batch.posts) else None
        for i, (fut, post) in enumerate(zip(batch.futures, batch.posts)):
            try:
                src = host if post is not None else out
                row_out = src[i] if lens is None else src[i][:lens[i]]
                fut._set(post(row_out) if post is not None else row_out)
            except BaseException as e:  # noqa: BLE001
                fut._set_error(e)

    def _flush_batch(self, batch: _Batch) -> None:
        t0 = time.perf_counter()
        try:
            lens = None
            if batch.ragged:
                lens = [int(r.shape[0]) for r in batch.rows]
                width = max(lens)
                X = torch.stack([
                    r if int(r.shape[0]) == width
                    else F.pad(r, (0, width - int(r.shape[0])))
                    for r in batch.rows])
            else:
                X = torch.stack(batch.rows)
            with dispatch.count_launches() as c:
                out = self._runtime._run_batch(batch.family, X, batch.shared,
                                               row_lens=lens)
            with self._cv:
                self._flushes += 1
                if len(batch.rows) >= self.max_batch:
                    self._full_flushes += 1
                else:
                    self._window_flushes += 1
                self._launches += c.delta
                self._max_coalesce = max(self._max_coalesce, len(batch.rows))
        except BaseException as e:  # noqa: BLE001 - batch failed: isolate
            # poison-request isolation: one bad request must not take
            # down its K-1 co-travellers, so the batch falls back to
            # bounded per-row retries
            self._retry_rows(batch, e)
            return
        self._scatter(batch, out, lens)
        with self._cv:
            self._flush_s.append(time.perf_counter() - t0)

    def _deadline_error(self, batch: _Batch, i: int) -> TimeoutError:
        elapsed = time.monotonic() - batch.submits[i]
        return TimeoutError(
            f"request deadline exceeded: {elapsed:.3f}s elapsed of "
            f"{batch.budgets[i]:.3f}s budget (family={batch.family!r}, "
            f"row_length={int(batch.rows[i].shape[0])})")

    def _retry_rows(self, batch: _Batch, batch_err: BaseException) -> None:
        """Re-run a failed flush one row at a time: `ROW_ATTEMPTS`
        attempts per row with exponential backoff, each row's TOTAL
        budget (from submit) bounded by its own deadline.  A row that
        never succeeds fails only its own future."""
        with self._cv:
            self._batch_retries += 1
        for i, fut in enumerate(batch.futures):
            if fut.done():
                continue
            with self._cv:
                self._isolated_rows += 1
            dl, post = batch.deadlines[i], batch.posts[i]
            last: BaseException = batch_err
            for k in range(ROW_ATTEMPTS):
                now = time.monotonic()
                if dl is not None and now >= dl:
                    last = self._deadline_error(batch, i)
                    break
                if k:
                    with self._cv:
                        self._row_retries += 1
                    delay = min(0.0005 * (2 ** k), 0.05)
                    if dl is not None:
                        delay = min(delay, max(0.0, dl - now))
                    time.sleep(delay)
                    if dl is not None and time.monotonic() >= dl:
                        last = self._deadline_error(batch, i)
                        break
                try:
                    row = batch.rows[i].reshape(1, -1)
                    # a lone ragged row needs no padding: its true
                    # length IS the operand width
                    lens = [int(row.shape[-1])] if batch.ragged else None
                    with dispatch.count_launches() as c:
                        out = self._runtime._run_batch(
                            batch.family, row, batch.shared, row_lens=lens)
                    with self._cv:
                        self._launches += c.delta
                    res = out[0].cpu() if post is not None else out[0]
                    fut._set(post(res) if post is not None else res)
                    break
                except BaseException as e:  # noqa: BLE001
                    last = e
            if not fut.done():
                with self._cv:
                    self._row_failures += 1
                fut._set_error(last)

    # -- control ---------------------------------------------------------
    def flush(self, wait: bool = True, timeout: float = 30.0) -> None:
        """Force every forming batch to flush now; with ``wait`` block
        until the queue and in-flight work drain."""
        deadline = time.monotonic() + timeout
        with self._cv:
            for b in self._batches.values():
                b.deadline = 0.0
            if self._batches:
                self._ensure_thread()
            self._cv.notify_all()
            while wait and (self._batches or self._inflight):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("executor flush timed out")
                self._cv.wait(min(remaining, 0.1))

    def close(self, timeout: float = 30.0, drain: bool = True) -> None:
        """Stop the worker; no future is ever left unset.  With
        ``drain`` (default) queued batches still flush first; with
        ``drain=False`` they fail immediately.  Whatever remains pending
        after ``timeout`` fails with ``RuntimeError("executor closed")``."""
        undrained: list = []
        with self._cv:
            self._closed = True
            if not drain:
                undrained = list(self._batches.values())
                self._batches.clear()
            self._cv.notify_all()
            thread = self._thread
        for b in undrained:
            for fut in b.futures:
                fut._set_error(RuntimeError("executor closed"))
        if thread is not None and thread.is_alive():
            thread.join(timeout=timeout)
        with self._cv:
            leftovers = list(self._batches.values()) + \
                list(self._inflight_batches)
            self._batches.clear()
        for b in leftovers:
            for fut in b.futures:
                fut._set_error(RuntimeError("executor closed"))

    def flush_seconds(self) -> list:
        """Host seconds of each of the last `FLUSH_HISTORY` successful
        flushes, from stacking the rows to resolving their futures.  A
        flush whose requests have post steps (the sampler) copies its
        output to the host, so its time includes its device work."""
        with self._cv:
            return list(self._flush_s)

    def stats(self) -> dict:
        """Coalesce-factor counters: K requests per flush at 2 launches
        each is the whole value proposition, so it is measured."""
        with self._cv:
            return {
                "requests": self._requests,
                "flushes": self._flushes,
                "launches": self._launches,
                "pending": sum(len(b.rows) for b in self._batches.values()),
                "max_coalesce": self._max_coalesce,
                "coalesce_factor": (self._requests / self._flushes
                                    if self._flushes else 0.0),
                "launches_per_request": (self._launches / self._requests
                                         if self._requests else 0.0),
                "window_s": self.window,
                "max_batch": self.max_batch,
                "window_flushes": self._window_flushes,
                "full_flushes": self._full_flushes,
                "drained_rows": self._drained_rows,
                "batch_retries": self._batch_retries,
                "isolated_rows": self._isolated_rows,
                "row_retries": self._row_retries,
                "row_failures": self._row_failures,
            }
