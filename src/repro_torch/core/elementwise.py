"""ElementwiseKernel — generated elementwise kernels (paper §5.2, Fig. 4).

The user supplies an argument list and a C-like snippet; the toolkit
supplies loop slicing and driver code.  The family only *describes* the
computation — the C statements, argument metadata, output dtypes (an
`ElementwiseSpec`) — and hands it with a bucketed geometry to an
execution backend: ``cuda`` renders it into a CUDA C kernel, ``eager``
into torch operations.

    lin_comb = ElementwiseKernel(
        "float a, float *x, float b, float *y, float *z",
        "z[i] = a*x[i] + b*y[i]")
    z = lin_comb(5.0, x, 6.0, y, z)          # flat layout, global index i

The flat layout (default) runs over the ``n`` elements of the first
vector argument in any shape (outputs take their template's shape); a
snippet may read the global element index ``i`` itself.  Element counts
round up to power-of-two row buckets (`dispatch.bucket_rows`), so one
driver serves every ``n`` in the bucket.

The row layout (``layout="rows"``) keeps ``(B, N)`` operands 2-D:
buckets cover both dimensions (`dispatch.bucket_batch` ×
`bucket_cols`), and `BroadcastArg` inputs bind per-row ``(B, 1)`` or
per-col ``(1, N)`` values — how computed row reductions and shared
feature weights enter a fused 2-D epilogue:

    epi = ElementwiseKernel(
        [BroadcastArg(torch.float32, "r0", "row"),
         BroadcastArg(torch.float32, "r1", "row"),
         VectorArg(torch.float32, "x"), VectorArg(torch.float32, "out")],
        "out[i] = cumsumf(expf(x[i] - r0) / r1)", layout="rows")
    cdf = epi(row_max, row_sum, x, x, row_lens=lens)

With ``row_lens=`` every output is zero past its row's length.
Autotuning ``block_rows`` waits for ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import re

import numpy as np

from repro_torch.core import backends, dispatch, snippets
from repro_torch.core.backends.base import ElementwiseSpec
from repro_torch.core.cache import stable_hash
from repro_torch.core.platform import (BroadcastArg, ScalarArg, VectorArg,
                                       arg_kind, parse_arguments,
                                       rows_geometry)


class ElementwiseKernel:
    """Generate + cache a fused elementwise kernel from a C-like snippet."""

    def __init__(self, arguments, operation: str, name: str = "eltwise",
                 preamble: str = "", block_rows: int | None = None,
                 layout: str = "flat", backend: "str | None" = None):
        self.args = parse_arguments(arguments)
        self.operation = operation
        self.name = re.sub(r"\W", "_", name)
        self.preamble = preamble
        self.block_rows = block_rows
        self.layout = layout
        self.backend = backend  # None: resolve per call (env, then device)

        self.scalar_args = [a for a in self.args if isinstance(a, ScalarArg)]
        self.vector_args = [a for a in self.args if isinstance(a, VectorArg)]
        self.bcast_args = [a for a in self.args if isinstance(a, BroadcastArg)]
        if layout not in ("flat", "rows"):
            raise ValueError(f"unknown layout {layout!r} (flat | rows)")
        if self.bcast_args and layout != "rows":
            raise ValueError("BroadcastArg requires layout='rows' "
                             "(per-row/per-col binding needs the 2-D layout)")
        self.out_names = snippets.written_names(operation)
        unknown = set(self.out_names) - {v.name for v in self.vector_args}
        if unknown:
            raise ValueError(f"snippet writes undeclared vectors: {sorted(unknown)}")
        if not self.out_names:
            raise ValueError("elementwise snippet writes no vector (need e.g. 'z[i] = ...')")
        needs_i = snippets.uses_index(operation)
        if layout == "rows" and needs_i:
            raise ValueError("row-layout kernels have no flat element index "
                             "'i'; address data per block instead")
        statements = snippets.split_statements(operation)
        names = [a.name for a in self.args]
        self._first_vec_pos = names.index(self.vector_args[0].name)
        self._arg_meta = tuple((a.name, a.torch_dtype, arg_kind(a))
                               for a in self.args)
        self._out_positions = [names.index(o) for o in self.out_names]
        out_dtypes = {v.name: v.torch_dtype for v in self.vector_args}
        # vectors read anywhere on a right-hand side (incl. read-modify-write)
        rhs = [snippets.split_statement(s)[2] for s in statements]
        loaded = sorted({v.name for v in self.vector_args + self.bcast_args
                         if any(re.search(rf"\b{re.escape(v.name)}\b", e)
                                for e in rhs)})
        self.spec = ElementwiseSpec(
            name=self.name,
            arg_meta=self._arg_meta,
            scalar_names=tuple(s.name for s in self.scalar_args),
            loaded_vectors=tuple(loaded),
            body_lines=tuple(statements),
            out_names=tuple(self.out_names),
            out_dtypes=tuple(out_dtypes[o] for o in self.out_names),
            needs_i=needs_i,
            preamble=self.preamble,
        )
        self._content_key = stable_hash(self.spec.token())

    def render(self, block_rows: int, ncols: "int | None" = None,
               backend: "str | None" = None, ragged: bool = False) -> str:
        """Source this kernel's spec renders to on ``backend`` (debug/
        introspection surface; drivers render internally): the flat
        layout when ``ncols`` is None, else ``ncols``-wide rows."""
        from repro_torch.core import ir
        from repro_torch.core.platform import LANES

        kir = ir.lower_elementwise(
            self.spec, rows=block_rows,
            lanes=LANES if ncols is None else ncols,
            layout="flat" if ncols is None else "rows", ragged=ragged)
        kir = ir.tile(ir.tag_parallel(kir, "rows"), "rows", block_rows)
        return backends.get_backend(backend or self.backend).render_ir(kir)

    # -- driver -----------------------------------------------------------
    def __call__(self, *call_args, block_rows: int | None = None,
                 backend: "str | None" = None, row_lens=None):
        first = call_args[self._first_vec_pos]
        be = backends.get_backend(backend or self.backend, first)
        if row_lens is not None and self.layout != "rows":
            raise ValueError("row_lens= requires layout='rows' "
                             "(per-row masking needs the 2-D layout)")
        if self.layout == "rows":
            return self._call_rows(call_args, block_rows, be, row_lens)
        shape = tuple(first.shape)
        n = int(np.prod(shape, dtype=np.int64))
        br = block_rows or self.block_rows or dispatch.default_block_rows(n)
        bucket = dispatch.bucket_rows(n, br)
        key = ("eltwise", be.name, self._content_key, bucket,
               br if be.block_sensitive else 0)
        drv = dispatch.get_or_build(
            key,
            lambda: be.elementwise_driver(self.spec, bucket=bucket,
                                          block_rows=br),
            backend=be.name, name=self.name, bucket=(bucket,))
        outs = [o.reshape(shape) for o in dispatch.run_with_retries(
            lambda: drv(n, call_args), site="launch", backend=be.name,
            family=self.name, bucket=(bucket,))]
        dispatch.record_launch(be.name)  # after the driver: failed launches don't count
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _call_rows(self, call_args, block_rows, be, row_lens):
        first = call_args[self._first_vec_pos]
        ragged = row_lens is not None
        b, n = rows_geometry(first)
        br = block_rows or self.block_rows or dispatch.default_batch_block(b)
        brows = dispatch.bucket_batch(b, br)
        ncols = dispatch.bucket_cols(n)
        key = ("eltwise_rows", be.name, self._content_key, brows, ncols,
               br if be.block_sensitive else 0)
        if ragged:
            key = key + ("R",)
        site_bucket = (brows, ncols, "R") if ragged else (brows, ncols)
        drv = dispatch.get_or_build(
            key,
            lambda: be.elementwise_rows_driver(self.spec, brows=brows,
                                               ncols=ncols, block_rows=br,
                                               ragged=ragged),
            backend=be.name, name=self.name, bucket=site_bucket)
        outs = dispatch.run_with_retries(
            lambda: drv(b, n, call_args, row_lens), site="launch",
            backend=be.name, family=self.name, bucket=site_bucket)
        # each output takes the shape of its template argument
        outs = [o.reshape(call_args[p].shape)
                for o, p in zip(outs, self._out_positions)]
        dispatch.record_launch(be.name)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def autotune(self, *call_args, **kwargs):
        raise NotImplementedError(
            "per-bucket autotuning of block_rows (an H100 cost model or a "
            "wall-clock tuner) is ported with ROADMAP Queue 1 item 6")
