"""Content hashing, the bounded driver LRU and the environment fingerprint.

PyCUDA keys its compiler cache on (source, compiler options, hardware +
software environment).  The port keeps the same three pieces as the JAX
package's ``core/cache.py``: `stable_hash` (byte-identical to the JAX
package's, so tokens hash the same in both), the thread-safe `LRUCache`
that bounds compiled drivers, and `environment_fingerprint`, whose
jax fields become torch / CUDA / SM-capability fields.  The JSON
``DiskCache`` waits for the warm-start manifest (ROADMAP Queue 1).
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from typing import Any, Callable


def environment_fingerprint(backend: str | None = None) -> dict:
    """Identifying information about hardware + software (paper section 5:
    'means for the easy gathering of identifying information regarding
    hardware, software and their corresponding versions').

    ``backend`` pins the RTCG execution backend; by default it reads
    the process-wide ``REPRO_TORCH_BACKEND`` selection (``"auto"`` when
    unset: per-tensor resolution)."""
    import platform

    import torch

    if torch.cuda.is_available():
        device_kind = torch.cuda.get_device_name(0)
        major, minor = torch.cuda.get_device_capability(0)
        sm = f"sm_{major}{minor}"
    else:
        device_kind, sm = "none", "none"
    if backend is None:
        from repro_torch.core.backends import active_backend_name

        backend = active_backend_name() or "auto"
    from repro_torch.core.ir import IR_SCHEMA_VERSION

    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "python": platform.python_version(),
        "device_kind": device_kind,
        "sm": sm,
        "rtcg_backend": backend.lower(),
        "ir_schema": IR_SCHEMA_VERSION,
    }


def stable_hash(obj: Any) -> str:
    """Deterministic content hash of a JSON-able object or string/bytes."""
    if isinstance(obj, bytes):
        payload = obj
    elif isinstance(obj, str):
        payload = obj.encode()
    else:
        payload = json.dumps(obj, sort_keys=True, default=repr).encode()
    return hashlib.sha256(payload).hexdigest()


class LRUCache:
    """Bounded, thread-safe in-memory LRU for unserializable artifacts.

    Compiled kernel *drivers* (closures over loaded libraries) cannot be
    serialized, so the dispatch engine bounds them with this LRU —
    eviction means a later rebuild, never wrong results.  Hit/miss/
    eviction counters are exposed for tests and reports.
    """

    def __init__(self, maxsize: int = 256):
        if maxsize < 1:
            raise ValueError("LRUCache maxsize must be >= 1")
        self.maxsize = maxsize
        self._data: OrderedDict[Any, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Any, default: Any = None) -> Any:
        with self._lock:
            try:
                val = self._data[key]
            except KeyError:
                self.misses += 1
                return default
            self._data.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key: Any, value: Any) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1

    def get_or_create(self, key: Any, factory: Callable[[], Any],
                      on_create: Callable[[], None] | None = None) -> Any:
        """Lookup, building+inserting via ``factory`` on miss.

        The factory runs outside the lock (it may compile for seconds);
        concurrent misses on the same key may build twice — harmless,
        last write wins.
        """
        sentinel = object()
        val = self.get(key, sentinel)
        if val is sentinel:
            val = factory()
            if on_create is not None:
                on_create()
            self.put(key, val)
        return val

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            return key in self._data

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._data), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}
