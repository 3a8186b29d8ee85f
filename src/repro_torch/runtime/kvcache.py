"""Per-request KV-cache slot pool — admission, eviction, explicit shed.

Continuous-batching decode keeps ONE device-resident batch cache of
fixed capacity ``B`` (``transformer.init_cache(cfg, B, max_len)``);
requests do not own cache memory, they *lease a slot* of it for their
lifetime.  This module is the bookkeeping side of that lease:

  * `admit` assigns a free slot to a request (or raises
    `FleetOverloadError` — capacity exhaustion is an explicit shed);
  * `release` returns the slot on normal completion;
  * `evict` reclaims it early (deadline passed, client gone), counted
    separately;
  * `expired` lists the requests whose absolute deadline has passed.

The pool never touches device memory: slot indices are what the serving
engine uses to scatter a prefilled row cache into the batch cache.  The
port of the JAX package's ``runtime/kvcache.py``, with its own
`FleetOverloadError` (the fleet module that defines it there is not
ported yet) and without the metrics registry.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


class FleetOverloadError(RuntimeError):
    """Admission refused: the pool (or a bounded queue) is full.  The
    request is shed explicitly rather than buffered without bound."""


@dataclass
class _Lease:
    slot: int
    prompt_len: int
    admitted_at: float
    deadline: "float | None"    # absolute monotonic seconds, or None


class RequestsCache:
    """Capacity-bounded request -> cache-slot lease table (thread-safe).

    ``capacity`` is the batch dimension of the device cache this pool
    fronts.  ``clock`` is injectable for deterministic deadline tests.
    """

    def __init__(self, capacity: int, clock=time.monotonic):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._free = list(range(self.capacity - 1, -1, -1))  # pop() -> slot 0 first
        self._leases: dict = {}         # request id -> _Lease
        self._admitted = 0
        self._released = 0
        self._evicted = 0
        self._expired = 0
        self._shed = 0

    # -- admission --------------------------------------------------------
    def admit(self, request_id, prompt_len: int,
              deadline: "float | None" = None) -> int:
        """Lease a slot to ``request_id``; returns the slot index.  A full
        pool raises `FleetOverloadError`."""
        with self._lock:
            if request_id in self._leases:
                raise ValueError(f"request {request_id!r} already admitted")
            if not self._free:
                self._shed += 1
                raise FleetOverloadError(
                    f"KV cache full: {self.capacity} slots live, "
                    f"request {request_id!r} shed")
            now = self._clock()
            slot = self._free.pop()
            self._leases[request_id] = _Lease(
                slot, int(prompt_len), now,
                None if deadline is None else now + float(deadline))
            self._admitted += 1
            return slot

    def has_free_slot(self) -> bool:
        with self._lock:
            return bool(self._free)

    # -- completion / reclamation ----------------------------------------
    def _reclaim(self, request_id) -> int:
        lease = self._leases.pop(request_id, None)
        if lease is None:
            raise KeyError(f"request {request_id!r} holds no slot")
        self._free.append(lease.slot)
        return lease.slot

    def release(self, request_id) -> int:
        """Return the slot on normal completion; -> the freed slot."""
        with self._lock:
            slot = self._reclaim(request_id)
            self._released += 1
        return slot

    def evict(self, request_id, expired: bool = False) -> int:
        """Reclaim the slot early (deadline/cancel); -> the freed slot."""
        with self._lock:
            slot = self._reclaim(request_id)
            self._evicted += 1
            if expired:
                self._expired += 1
        return slot

    def expired(self, now: "float | None" = None) -> list:
        """Request ids whose absolute deadline has passed (unreclaimed)."""
        t = self._clock() if now is None else now
        with self._lock:
            return [rid for rid, lease in self._leases.items()
                    if lease.deadline is not None and t >= lease.deadline]

    # -- introspection ----------------------------------------------------
    def slot_of(self, request_id) -> "int | None":
        with self._lock:
            lease = self._leases.get(request_id)
            return None if lease is None else lease.slot

    def live(self) -> list:
        """Request ids currently holding a slot, in slot order."""
        with self._lock:
            return [rid for rid, _ in sorted(self._leases.items(),
                                             key=lambda kv: kv[1].slot)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._leases)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "live": len(self._leases),
                "admitted": self._admitted,
                "released": self._released,
                "evicted": self._evicted,
                "expired": self._expired,
                "shed": self._shed,
            }
