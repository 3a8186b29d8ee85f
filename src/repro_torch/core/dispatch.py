"""Dispatch engine — shape-bucketed drivers + a low-overhead launch path.

The paper's economics (Fig. 2) only work if a generated kernel is cheap
to *re-launch*: compilation is amortized by the cache, so the steady
state must be a dictionary lookup.  The port keeps the JAX package's
bucketing math and counters unchanged:

  * a flat workload of ``n`` elements buckets to ``bucket_rows`` rows
    of 128, a ``(B, N)`` row workload to ``(bucket_batch, bucket_cols)``
    — powers of two — and one driver serves the whole bucket, so a
    size sweep over a ``k×`` range builds ``ceil(log2(k)) + 1`` drivers;
  * drivers live in one bounded, shared `LRUCache` keyed per backend;
  * the compile and launch counters count driver builds and successful
    driver calls, *tagged per backend*, and `count_launches` /
    `count_compiles` read them around a block;
  * beside them, each hand-written kernel's wrapper counts its own
    launches by kernel name (`record_kernel_launch`), so one
    `reset_counters` and one `count_launches` cover both.

The CUDA sources do not depend on the bucket (they take ``b``/``n`` at
run time), but the keys keep it, so driver-build and launch counts match
the JAX package's.  `run_with_retries` is a plain call until the fault
harness is ported (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from repro_torch.core.cache import LRUCache
from repro_torch.core.platform import LANES

#: LRU entries (the JAX package's default; the port reads no
#: environment variable of the JAX package's)
_DEFAULT_CACHE_SIZE = 256

_driver_cache = LRUCache(maxsize=_DEFAULT_CACHE_SIZE)

_counter_lock = threading.Lock()
_UNTAGGED = "untagged"  # counter tag when a caller does not name a backend
_compile_counts: dict[str, int] = {}
_launch_counts: dict[str, int] = {}
_kernel_counts: dict[str, int] = {}


def run_with_retries(fn: Callable[[], Any], *, site: str,
                     backend: "str | None" = None,
                     family: "str | None" = None,
                     bucket: "tuple | None" = None) -> Any:
    """The JAX package's fault-probe / bounded-retry seam around every
    compile and launch.  The port has no fault harness yet, so this is
    a plain call; the signature stays so the call sites need no change
    when it lands."""
    return fn()


# ----------------------------------------------------------------- buckets
def next_pow2(x: int) -> int:
    """Smallest power of two >= x (x >= 1)."""
    return 1 << (max(1, int(x)) - 1).bit_length()


def bucket_rows(n: int, block_rows: int, lanes: int = LANES) -> int:
    """Padded row count of ``n`` elements in ``lanes``-wide rows, rounded
    to its pow2 bucket and a multiple of ``block_rows``: the flat
    layout's bucket (the CUDA kernels mask at ``n``; the bucket keys the
    driver, so a size sweep builds as many drivers as in the JAX
    package)."""
    rows = -(-n // lanes)
    rows = -(-rows // block_rows) * block_rows
    bucket = next_pow2(rows)
    return -(-bucket // block_rows) * block_rows


def n_bucket(n: int, lanes: int = LANES) -> int:
    """Shape bucket of an element count, independent of ``block_rows``."""
    return next_pow2(-(-n // lanes))


def default_block_rows(n: int, lanes: int = LANES, target_grid: int = 8,
                       min_rows: int = 8, max_rows: int = 512) -> int:
    """Bucket-derived default flat ``block_rows`` (the JAX package's
    rule, kept so both packages pick the same bucket per ``n``)."""
    br = n_bucket(n, lanes) // target_grid
    return max(min_rows, min(max_rows, br or min_rows))


def bucket_batch(b: int, block_rows: int) -> int:
    """Padded batch-row count for a row-segmented kernel over ``(B, N)``
    operands: next multiple of ``block_rows``, then the next power of
    two, so a batch-size sweep over a ``k×`` range builds
    ``<= ceil(log2(k)) + 1`` drivers."""
    rows = -(-max(1, int(b)) // block_rows) * block_rows
    bucket = next_pow2(rows)
    return -(-bucket // block_rows) * block_rows


def bucket_cols(n: int, lanes: int = LANES) -> int:
    """Bucketed row length: a power-of-two number of LANES-wide groups."""
    return next_pow2(-(-max(1, int(n)) // lanes)) * lanes


def rc_bucket(b: int, n: int, lanes: int = LANES,
              transposed: bool = False, ragged: bool = False) -> tuple:
    """(batch, row-length) bucket pair, with a ``"T"`` marker for the
    transposed (axis=0) layout and an ``"R"`` marker for the ragged form
    so their cells never collide with the dense ones."""
    pair = (next_pow2(max(1, int(b))), next_pow2(-(-max(1, int(n)) // lanes)))
    if transposed:
        pair = pair + ("T",)
    if ragged:
        pair = pair + ("R",)
    return pair


def default_batch_block(b: int, target_grid: int = 8, min_rows: int = 1,
                        max_rows: int = 256) -> int:
    """Bucket-derived default batch ``block_rows`` for row-segmented
    kernels (a single-row sampler batch must not pay a row-padding
    tax, hence ``min_rows=1``)."""
    br = next_pow2(max(1, int(b))) // target_grid
    return max(min_rows, min(max_rows, br or min_rows))


# ------------------------------------------------------------ driver cache
def get_or_build(key: Any, builder: Callable[[], Callable],
                 backend: str | None = None, name: str | None = None,
                 bucket: "tuple | None" = None) -> Callable:
    """Shared-LRU lookup; on miss, build + count one driver compile
    against ``backend``'s tag.  Callers put the backend name in ``key``
    too — the tag only labels the counter."""
    tag = backend or _UNTAGGED
    return _driver_cache.get_or_create(
        key, lambda: run_with_retries(builder, site="compile", backend=tag,
                                      family=name, bucket=bucket),
        on_create=lambda: _record(_compile_counts, tag))


def _record(counts: dict, tag: str) -> None:
    with _counter_lock:
        counts[tag] = counts.get(tag, 0) + 1


def record_launch(backend: str | None = None) -> None:
    _record(_launch_counts, backend or _UNTAGGED)


def record_kernel_launch(kernel: str) -> None:
    """Count one launch of a hand-written kernel; its wrapper calls this
    after a launch that returned no error, and nowhere else."""
    _record(_kernel_counts, kernel)


def compile_counts() -> dict[str, int]:
    with _counter_lock:
        return dict(_compile_counts)


def launch_counts() -> dict[str, int]:
    with _counter_lock:
        return dict(_launch_counts)


def kernel_launch_counts() -> dict[str, int]:
    with _counter_lock:
        return dict(_kernel_counts)


def _deltas(start: dict, end: dict) -> dict:
    return {k: d for k in end if (d := end[k] - start.get(k, 0)) > 0}


class _DeltaCounter:
    """Context manager over one counter map: ``delta`` after exit is the
    count inside the block, ``by_backend`` the nonzero per-backend
    deltas — so a test can assert both the schedule length and *which*
    backend executed it.  ``by_kernel`` holds the nonzero deltas of the
    per-kernel map, when one is given."""

    def __init__(self, snapshot: Callable[[], dict],
                 kernels: "Callable[[], dict] | None" = None):
        self._snapshot = snapshot
        self._kernels = kernels or dict

    def __enter__(self):
        self._start = self._snapshot()
        self._kstart = self._kernels()
        self.delta = 0
        self.by_backend: dict[str, int] = {}
        self.by_kernel: dict[str, int] = {}
        return self

    def __exit__(self, *exc):
        self.by_backend = _deltas(self._start, self._snapshot())
        self.by_kernel = _deltas(self._kstart, self._kernels())
        self.delta = sum(self.by_backend.values())
        return False


def count_launches() -> _DeltaCounter:
    """``with dispatch.count_launches() as c: ...; c.delta`` — e.g. one
    ragged sampler flush is a reduction wave plus one epilogue: 2
    (``c.by_kernel`` names the hand-written kernels that ran)."""
    return _DeltaCounter(launch_counts, kernel_launch_counts)


def count_compiles() -> _DeltaCounter:
    """Compile-side twin of `count_launches`."""
    return _DeltaCounter(compile_counts)


def reset_counters() -> None:
    with _counter_lock:
        _compile_counts.clear()
        _launch_counts.clear()
        _kernel_counts.clear()


def stats() -> dict:
    s = _driver_cache.stats()
    s["compiles_by_backend"] = compile_counts()
    s["launches_by_backend"] = launch_counts()
    s["launches_by_kernel"] = kernel_launch_counts()
    return s
