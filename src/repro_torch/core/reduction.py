"""ReductionKernel — generated map+reduce kernels (paper §5.2).

PyCUDA's ReductionKernel takes a ``map_expr`` applied per element and a
``reduce_expr`` combining pairs, plus a neutral element.  The family
describes that computation as a `ReductionSpec` — the snippets stay C —
and hands it, with a bucketed geometry, to an execution backend:
``cuda`` renders the spec into a CUDA C reduction, ``eager`` into torch
folds.

    dot = ReductionKernel(torch.float32, neutral="0", reduce_expr="a+b",
                          map_expr="x[i]*y[i]", arguments="float *x, float *y")
    dot(x, y)                                    # a 0-d tensor

Three forms:

  * flat (``axis=None``, default): the ``n`` elements of the first
    vector argument fold to one 0-d result per accumulator, in ONE
    launch; element counts bucket like the elementwise flat layout;
  * row-segmented (``axis=-1``): each row of a ``(B, N)`` operand
    reduces to its own accumulator in ONE launch, the runtime row length
    ``n`` (or, with ``row_lens=``, each row's own length) masking the
    columns past it with the neutral element; outputs are length-B
    vectors, and a later accumulator's map expression may reference an
    earlier one as ``_acc<k>`` — how stable softmax computes the row max
    *and* the shifted exp-sum in a single launch;
  * column-segmented (``axis=0``): each *column* of a ``(B, N)`` operand
    reduces to a length-N vector through the same segmented kernel over
    the IR's ``transpose_layout`` domain (per-row and per-col kinds swap;
    the operands are bound with swapped strides, never copied).

Multi-accumulator form: pass *lists* for ``dtype_out`` / ``neutral`` /
``reduce_expr`` / ``map_expr`` and every map expression folds in one
pass of the inputs — sibling reductions cost ONE launch:

    wave = ReductionKernel([torch.float32] * 2, ["-3.4e38", "0"],
                           ["fmaxf(a, b)", "a + b"],
                           ["x[i]", "expf(x[i] - _acc0)"],
                           "float *x", axis=-1)
    row_max, row_sum = wave(x)                   # or wave(x, row_lens=lens)

Arguments of the segmented forms may include `BroadcastArg`s (per-row
``(B, 1)`` or per-col ``(1, N)`` values); ``prelude`` lists extra C
assignment statements evaluated per element before the map expressions.
Autotuning ``block_rows`` waits for ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import re

import numpy as np

from repro_torch.core import backends, dispatch
from repro_torch.core.backends.base import ReductionSpec
from repro_torch.core.cache import stable_hash
from repro_torch.core.platform import (BroadcastArg, ScalarArg, VectorArg,
                                       arg_kind, canonical_dtype, dtype_name,
                                       parse_arguments, rows_geometry)

# Recognized pairwise reducers -> (target-neutral fold, C combine of a, b)
_BLOCK_REDUCERS = {
    "a+b": ("sum", "a + b"),
    "b+a": ("sum", "a + b"),
    "a*b": ("prod", "a * b"),
    "max(a,b)": ("max", "max(a, b)"),
    "fmaxf(a,b)": ("max", "fmaxf(a, b)"),
    "min(a,b)": ("min", "min(a, b)"),
    "fminf(a,b)": ("min", "fminf(a, b)"),
}


class ReductionKernel:
    def __init__(self, dtype_out, neutral, reduce_expr, map_expr,
                 arguments, name: str = "reduce", preamble: str = "",
                 block_rows: int | None = None, axis: int | None = None,
                 prelude=None, backend: "str | None" = None):
        # Normalize the single-output and multi-accumulator forms to lists;
        # `self.multi` records which way results are handed back.
        self.multi = isinstance(map_expr, (list, tuple))
        map_exprs = list(map_expr) if self.multi else [map_expr]
        k = len(map_exprs)

        def _aslist(v):
            return list(v) if isinstance(v, (list, tuple)) else [v] * k

        neutrals, reduce_exprs = _aslist(neutral), _aslist(reduce_expr)
        dtypes_out = _aslist(dtype_out)
        if not (len(neutrals) == len(reduce_exprs) == len(dtypes_out) == k):
            raise ValueError("dtype_out/neutral/reduce_expr/map_expr lengths differ")
        if axis not in (None, -1, 0):
            raise NotImplementedError("only axis=None (full), axis=-1 "
                                      "(row-segmented) or axis=0 "
                                      "(column-segmented) reductions")

        self.dtypes_out = [canonical_dtype(d) for d in dtypes_out]
        self.neutrals = [str(nt).strip() for nt in neutrals]
        self.reduce_exprs = reduce_exprs
        self.map_exprs = map_exprs
        self.args = parse_arguments(arguments)
        self.name = re.sub(r"\W", "_", name)
        self.preamble = preamble
        self.block_rows = block_rows
        self.backend = backend  # None: resolve per call (env, then device)
        self.axis = axis
        self.prelude = list(prelude or [])

        self._reducers = []
        for rexpr in reduce_exprs:
            key = re.sub(r"\s", "", rexpr)
            if key not in _BLOCK_REDUCERS:
                raise NotImplementedError(
                    f"reduce_expr {rexpr!r} not recognized; supported: {sorted(_BLOCK_REDUCERS)}")
            self._reducers.append(_BLOCK_REDUCERS[key])
        self.scalar_args = [a for a in self.args if isinstance(a, ScalarArg)]
        self.vector_args = [a for a in self.args if isinstance(a, VectorArg)]
        self.bcast_args = [a for a in self.args if isinstance(a, BroadcastArg)]
        if self.bcast_args and self.axis is None:
            raise ValueError("BroadcastArg requires a segmented form "
                             "(axis=-1 or axis=0); a flat reduction cannot "
                             "bind per-row/per-col values")
        if not self.vector_args:
            raise ValueError("reduction needs at least one vector argument")
        names = [a.name for a in self.args]
        self._first_vec_pos = names.index(self.vector_args[0].name)
        self._arg_meta = tuple((a.name, a.torch_dtype, arg_kind(a))
                               for a in self.args)
        outs = [{"map_expr": mapped, "neutral": nt, "reducer": fold,
                 "combine": combine, "dtype": dtype_name(dt)}
                for mapped, nt, (fold, combine), dt in zip(
                    self.map_exprs, self.neutrals, self._reducers,
                    self.dtypes_out)]
        exprs = self.map_exprs + self.prelude
        loaded = sorted({v.name for v in (self.vector_args + self.bcast_args)
                         if any(re.search(rf"\b{re.escape(v.name)}\b", e)
                                for e in exprs)})
        self.spec = ReductionSpec(
            name=self.name,
            arg_meta=self._arg_meta,
            scalar_names=tuple(s.name for s in self.scalar_args),
            loaded_vectors=tuple(loaded),
            prelude_lines=tuple(self.prelude),
            outs=tuple(outs),
            multi=self.multi,
            axis=self.axis,
            preamble=self.preamble,
        )
        self._content_key = stable_hash(self.spec.token())

    def render(self, block_rows: int, ncols: "int | None" = None,
               backend: "str | None" = None, ragged: bool = False) -> str:
        """Source this kernel's spec renders to on ``backend``."""
        from repro_torch.core import ir
        from repro_torch.core.platform import LANES

        if self.axis is None:
            kir = ir.lower_reduction(self.spec, rows=block_rows, cols=LANES)
        else:
            kir = ir.lower_reduction(self.spec, rows=block_rows, cols=ncols,
                                     layout="rows", ragged=ragged)
            if self.axis == 0:
                kir = ir.transpose_layout(kir)
            kir = ir.tag_parallel(kir, "rows")
        kir = ir.tile(kir, "rows", block_rows)
        return backends.get_backend(backend or self.backend).render_ir(kir)

    # -- driver -----------------------------------------------------------
    def __call__(self, *call_args, block_rows: int | None = None,
                 backend: "str | None" = None, row_lens=None):
        first = call_args[self._first_vec_pos]
        be = backends.get_backend(backend or self.backend, first)
        if row_lens is not None and self.axis is None:
            raise ValueError("row_lens requires the row-segmented form "
                             "(axis=-1)")
        if self.axis is not None:
            return self._call_rows(call_args, block_rows, be, row_lens)
        n = int(np.prod(tuple(first.shape), dtype=np.int64))
        br = block_rows or self.block_rows or dispatch.default_block_rows(n)
        bucket = dispatch.bucket_rows(n, br)
        key = ("reduce", be.name, self._content_key, bucket,
               br if be.block_sensitive else 0)
        drv = dispatch.get_or_build(
            key,
            lambda: be.reduction_driver(self.spec, bucket=bucket,
                                        block_rows=br),
            backend=be.name, name=self.name, bucket=(bucket,))
        out = dispatch.run_with_retries(
            lambda: drv(n, call_args), site="launch", backend=be.name,
            family=self.name, bucket=(bucket,))
        dispatch.record_launch(be.name)  # after the driver: failed launches don't count
        return out

    def _domain_geometry(self, first) -> tuple[int, int]:
        """Kernel-domain (rows, cols) counts: axis=0 reduces each storage
        *column*, so `transpose_layout` makes every output column a
        domain row — (B, N) storage becomes an (N, B) domain."""
        b, n = rows_geometry(first)
        return (n, b) if self.axis == 0 else (b, n)

    def _call_rows(self, call_args, block_rows, be, row_lens):
        ragged = row_lens is not None
        b, n = self._domain_geometry(call_args[self._first_vec_pos])
        br = block_rows or self.block_rows or dispatch.default_batch_block(b)
        brows = dispatch.bucket_batch(b, br)
        ncols = dispatch.bucket_cols(n)
        key = ("reduce_rows", be.name, self._content_key, brows, ncols,
               br if be.block_sensitive else 0)
        site_bucket = (brows, ncols, "R") if ragged else (brows, ncols)
        if ragged:
            key = key + ("R",)
        drv = dispatch.get_or_build(
            key,
            lambda: be.reduction_rows_driver(self.spec, brows=brows,
                                             ncols=ncols, block_rows=br,
                                             ragged=ragged),
            backend=be.name, name=self.name, bucket=site_bucket)
        out = dispatch.run_with_retries(
            lambda: drv(b, n, call_args, row_lens), site="launch",
            backend=be.name, family=self.name, bucket=site_bucket)
        dispatch.record_launch(be.name)  # after the driver: failed launches don't count
        return out

    def autotune(self, *call_args, **kwargs):
        raise NotImplementedError(
            "per-bucket autotuning of block_rows (an H100 cost model or a "
            "wall-clock tuner) is ported with ROADMAP Queue 1 item 6")


__all__ = ["ReductionKernel"]
