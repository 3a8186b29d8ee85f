"""ScanKernel — generated prefix-scan kernels (PyCUDA's pycuda.scan).

PyCUDA ships Inclusive/ExclusiveScanKernel alongside ElementwiseKernel
and ReductionKernel; the combine operator comes from a C-like snippet
(``"a+b"``, ``"fmaxf(a,b)"``).  The family describes the scan
(`ScanSpec`: fold, neutral, dtype, exclusivity) and hands it to an
execution backend:

  * ``cuda``: the classic two-pass blocked scan, both passes generated
    from `scan.cu.j2` — per-tile inclusive scan + tile totals, the
    carries between them (an exclusive scan of the totals), then a
    carry pass;
  * ``eager``: one cumulative op over the whole stream.

    cumsum = InclusiveScanKernel(torch.float32, "a+b")
    cumsum(x)                       # x.shape, x's values scanned in order

Drivers are keyed per power-of-two *grid bucket* of ``block_n``-element
blocks (`repro_torch.core.dispatch`), as in the JAX package, so driver
builds match its counts; a call records ONE launch, although the CUDA
scan runs two kernels (each counts its own launches by kernel name).
``block_n`` keys the bucket only: the CUDA tile is a fixed 4096
elements, the JAX package's default.  Tuning ``block_n`` waits for
ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import re

import numpy as np

from repro_torch.core import backends, dispatch
from repro_torch.core.backends.base import ScanSpec
from repro_torch.core.cache import stable_hash
from repro_torch.core.platform import canonical_dtype, dtype_name

#: recognized combine snippets -> (fold, C combine, default neutral)
_SCAN_OPS = {
    "a+b": ("sum", "a + b", "0"),
    "b+a": ("sum", "a + b", "0"),
    "max(a,b)": ("max", "max(a, b)", "-3e38"),
    "fmaxf(a,b)": ("max", "fmaxf(a, b)", "-3e38"),
    "min(a,b)": ("min", "min(a, b)", "3e38"),
    "fminf(a,b)": ("min", "fminf(a, b)", "3e38"),
    "a*b": ("prod", "a * b", "1"),
}


class ScanKernel:
    """Generated blocked prefix scan.

    >>> cumsum = ScanKernel(torch.float32, "a+b", neutral="0")
    >>> cumsum(x)           # inclusive by default
    """

    def __init__(self, dtype, scan_expr: str, neutral: str | None = None,
                 name: str = "scan", exclusive: bool = False,
                 block_n: int = 4096, backend: "str | None" = None):
        key = re.sub(r"\s", "", scan_expr)
        if key not in _SCAN_OPS:
            raise NotImplementedError(
                f"scan_expr {scan_expr!r}; supported: {sorted(_SCAN_OPS)}")
        self.cumop, self.binop, default_neutral = _SCAN_OPS[key]
        self.neutral = neutral if neutral is not None else default_neutral
        self.dtype = canonical_dtype(dtype)
        self.name = re.sub(r"\W", "_", name)
        self.exclusive = exclusive
        self.block_n = block_n
        self.backend = backend  # None: resolve per call (env, then device)
        self.spec = ScanSpec(
            name=self.name,
            dtype=dtype_name(self.dtype),
            neutral=str(self.neutral),
            cumop=self.cumop,
            binop=self.binop,
            exclusive=self.exclusive,
        )
        self._content_key = stable_hash(self.spec.token())

    def __call__(self, x, block_n: int | None = None,
                 backend: "str | None" = None):
        be = backends.get_backend(backend or self.backend, x)
        shape = tuple(x.shape)
        n = int(np.prod(shape, dtype=np.int64))
        bn = block_n or self.block_n
        grid = dispatch.next_pow2(-(-n // bn))
        # block-insensitive backends only care about the padded stream
        # length grid*bn, so block_n values sharing it share a driver
        key = ("scan", be.name, self._content_key,
               (grid, bn) if be.block_sensitive else (grid * bn,))
        drv = dispatch.get_or_build(
            key, lambda: be.scan_driver(self.spec, grid=grid, block_n=bn),
            backend=be.name, name=self.name, bucket=(grid * bn,))
        out = dispatch.run_with_retries(
            lambda: drv(n, x), site="launch", backend=be.name,
            family=self.name, bucket=(grid * bn,)).reshape(shape)
        dispatch.record_launch(be.name)  # after the driver: failed launches don't count
        return out

    def render(self, backend: "str | None" = None) -> str:
        """Source this scan's spec renders to on ``backend`` (debug/
        introspection surface; drivers render internally)."""
        from repro_torch.core import ir

        return backends.get_backend(backend or self.backend).render_ir(
            ir.lower_scan(self.spec, n=0))

    def autotune(self, *args, **kwargs):
        raise NotImplementedError(
            "per-bucket autotuning of block_n (an H100 cost model or a "
            "wall-clock tuner) is ported with ROADMAP Queue 1 item 6")


def InclusiveScanKernel(dtype, scan_expr, **kw):
    return ScanKernel(dtype, scan_expr, exclusive=False, **kw)


def ExclusiveScanKernel(dtype, scan_expr, neutral, **kw):
    return ScanKernel(dtype, scan_expr, neutral=neutral, exclusive=True, **kw)
