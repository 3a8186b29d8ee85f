"""EagerBackend — the snippets as plain torch operations.

The counterpart of the JAX package's ``XlaBackend``: the kernel IR
renders to torch code over whole operands — masked segment reductions
(``torch.amax`` / ``torch.sum`` along the rows) with the same ``_acc<k>``
chaining, whole-array folds for the flat form, broadcast epilogues,
``cumsumf`` as ``torch.cumsum`` and prefix scans as one cumulative op —
exec'd through `SourceModule`, so generated code stays introspectable.
Tiled axes are ignored (there is no grid), and the operands keep their
exact shape: nothing in the code depends on the bucket, which is why
this backend is ``block_sensitive = False``.  One exception follows the
JAX package on purpose: a ragged row reduction whose row length runs
past the operand width reads the zero padding of the row's bucket
(`dispatch.bucket_cols`), as the JAX package's padded blocks do.

It is the plain version of the ``cuda`` backend's kernels: the CPU
tests run it against the JAX package, and the chip check holds every
CUDA kernel against it on the same card tensors.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch, snippets
from repro_torch.core.backends.base import (Backend, bind_flat_operands,
                                            bind_operands, bind_row_lens,
                                            operand_device)
from repro_torch.core.platform import canonical_dtype
from repro_torch.core.rtcg import SourceModule
from repro_torch.core.templates import KernelTemplate

# Row-segmented map+reduce: mask the columns past each row's length with
# the neutral element and fold along the row — the `_acc<k>` chaining
# contract (a later accumulator reads an earlier one per row) holds
# verbatim because the whole batch is one block.
_ROW_REDUCE_TMPL = KernelTemplate(
    "eager_row_reduction",
    '''
def {{ name }}_fn(_b, _ncols, _n, _dev{% for a in in_names %}, {{ a }}{% endfor %}):
    _BLK = (_b, _ncols)
    _mask = torch.arange(_ncols, device=_dev).reshape(1, _ncols) < _n
{% for line in prelude_lines %}
    {{ line }}
{% endfor %}
{% for o in outs %}
    _mapped{{ loop.index0 }} = torch.as_tensor({{ o.map_expr }}, device=_dev).to(torch.{{ o.dtype }}).expand(_BLK)
    _mapped{{ loop.index0 }} = torch.where(_mask, _mapped{{ loop.index0 }}, torch.tensor({{ o.neutral }}, dtype=torch.{{ o.dtype }}, device=_dev))
    _acc{{ loop.index0 }} = {{ o.fold }}(_mapped{{ loop.index0 }}{{ o.widen }}, dim=1, keepdim=True).to(torch.{{ o.dtype }})
{% endfor %}
    return ({% for o in outs %}_acc{{ loop.index0 }}[:, 0], {% endfor %})
''',
)

# Flat map+reduce: every element of the n-element stream is real (the
# operands are not padded), so each accumulator folds its whole mapped
# stream; no cross-step combine because there are no grid steps.
_REDUCE_TMPL = KernelTemplate(
    "eager_reduction",
    '''
def {{ name }}_fn(_n, _dev{% for a in in_names %}, {{ a }}{% endfor %}):
    _BLK = (_n,)
{% if needs_i %}
    i = torch.arange(_n, dtype=torch.int32, device=_dev)
{% endif %}
{% for line in prelude_lines %}
    {{ line }}
{% endfor %}
{% for o in outs %}
    _mapped{{ loop.index0 }} = torch.as_tensor({{ o.map_expr }}, device=_dev).to(torch.{{ o.dtype }}).expand(_BLK)
    _acc{{ loop.index0 }} = {{ o.fold }}(_mapped{{ loop.index0 }}{{ o.widen }}).to(torch.{{ o.dtype }})
{% endfor %}
    return ({% for o in outs %}_acc{{ loop.index0 }}, {% endfor %})
''',
)

# Elementwise, both layouts: the statements over the whole block
# (``_BLK`` is ``(n,)`` flat, ``(b, n)`` rows), written vectors kept in
# locals (in-place semantics); the flat layout's global index `i` is an
# int32 iota; the ragged form zeroes every output past its row's length.
_ELTWISE_TMPL = KernelTemplate(
    "eager_eltwise",
    '''
def {{ name }}_fn(_BLK, _n, _dev{% for a in in_names %}, {{ a }}{% endfor %}):
{% if needs_i %}
    i = torch.arange(_BLK[0], dtype=torch.int32, device=_dev)
{% endif %}
{% for line in body_lines %}
    {{ line }}
{% endfor %}
{% if ragged %}
    _keep = torch.arange(_BLK[1], device=_dev).reshape(1, _BLK[1]) < _n
{% for o in out_names %}
    {{ o }} = torch.where(_keep, {{ o }}, torch.zeros((), dtype={{ o }}.dtype, device=_dev))
{% endfor %}
{% endif %}
    return ({% for o in out_names %}{{ o }}, {% endfor %})
''',
)

# Prefix scan: one cumulative op over the whole stream with the neutral
# folded in once (what the two blocked passes compute), then the
# exclusive shift.
_SCAN_TMPL = KernelTemplate(
    "eager_scan",
    '''
def {{ name }}_fn(x):
    _nv = torch.tensor({{ neutral }}, dtype=x.dtype, device=x.device)
    _s = {{ inclusive }}
{% if exclusive %}
    return torch.cat([_nv.reshape(1), _s[:-1]])
{% else %}
    return _s
{% endif %}
''',
)

#: target-neutral reducer -> torch fold (whole array, or along dim=1)
_FOLDS = {"sum": "torch.sum", "prod": "torch.prod", "max": "torch.amax",
          "min": "torch.amin"}

#: scan fold -> inclusive scan of ``x`` with the neutral ``_nv`` folded in
_SCANS = {
    "sum": "torch.cumsum(x, 0).to(x.dtype) + _nv",
    "prod": "torch.cumprod(x, 0).to(x.dtype) * _nv",
    "max": "torch.maximum(torch.cummax(x, 0).values, _nv)",
    "min": "torch.minimum(torch.cummin(x, 0).values, _nv)",
}

def _wide(bound: list) -> list:
    """torch has next to no uint32 arithmetic: bind uint32 operands as
    int64 (the written outputs cast back, wrapping mod 2**32 as the C
    and JAX arithmetic do)."""
    return [t.to(torch.int64) if t.dtype == torch.uint32 else t
            for t in bound]


def _with_preamble(preamble: str, src: str) -> str:
    return (preamble + "\n" + src) if preamble else src


class EagerBackend(Backend):
    name = "eager"
    block_sensitive = False

    def fingerprint(self) -> dict:
        return {"backend": self.name, "torch": torch.__version__}

    # -- render (IR -> torch source) --------------------------------------
    def _body_lines(self, kir) -> list[str]:
        out_dtypes = dict(kir.outs)
        lines = []
        for stmt in kir.lines("body"):
            tgt, expr = snippets.translate_statement(stmt)
            if tgt in out_dtypes:
                # written vectors stay in locals, so later statements see
                # the updated value (CUDA in-place buffer semantics)
                lines.append(f"{tgt} = torch.as_tensor({expr}, device=_dev)"
                             f".to(torch.{out_dtypes[tgt]}).expand(_BLK)")
            elif tgt is not None:
                lines.append(f"{tgt} = {expr}")
            else:
                lines.append(expr)
        return lines

    def render_ir(self, kir) -> str:
        if kir.kind == "elementwise":
            src = _ELTWISE_TMPL.render(
                name=kir.name,
                in_names=[a[0] for a in kir.args],
                out_names=[o[0] for o in kir.outs],
                body_lines=self._body_lines(kir),
                needs_i=kir.meta_get("needs_i", False),
                ragged=kir.meta_get("ragged", False))
        elif kir.kind == "reduction":
            # (torch cannot take the max of uint32 values: fold in int64)
            outs = [dict(o, map_expr=snippets.translate_expression(o["map_expr"]),
                         neutral=snippets.translate_expression(o["neutral"]),
                         fold=_FOLDS[o["reducer"]],
                         widen=".to(torch.int64)" if o["dtype"] == "uint32"
                         else "") for o in kir.outs]
            prelude = [snippets.translate_assignment(s)
                       for s in kir.lines("prelude")]
            if kir.meta_get("layout") == "flat":
                exprs = [o["map_expr"] for o in outs] + prelude
                src = _REDUCE_TMPL.render(
                    name=kir.name, in_names=[a[0] for a in kir.args],
                    prelude_lines=prelude, outs=outs,
                    needs_i=any(snippets.uses_index(e) for e in exprs))
            else:
                src = _ROW_REDUCE_TMPL.render(
                    name=kir.name, in_names=[a[0] for a in kir.args],
                    prelude_lines=prelude, outs=outs)
        elif kir.kind == "scan":
            return _SCAN_TMPL.render(
                name=kir.name, dtype=kir.meta_get("dtype"),
                neutral=snippets.translate_expression(kir.meta_get("neutral")),
                exclusive=kir.meta_get("exclusive"),
                inclusive=_SCANS[kir.meta_get("cumop")])
        else:
            raise ValueError(f"unknown IR kind {kir.kind!r}")
        return _with_preamble(kir.meta_get("preamble", ""), src)

    def _compile(self, kir) -> Callable:
        return SourceModule.load(self.render_ir(kir), name=kir.name) \
            .get_function(f"{kir.name}_fn")

    # -- drivers -----------------------------------------------------------
    def build_elementwise(self, kir) -> Callable:
        fn = self._compile(kir)

        def driver(n, flat_args):
            device = operand_device(kir, flat_args)
            bound = _wide(bind_flat_operands(kir, n, flat_args, device))
            return list(fn((n,), n, device, *bound))

        return driver

    def build_elementwise_rows(self, kir) -> Callable:
        fn = self._compile(kir)
        ragged = bool(kir.meta_get("ragged", False))

        def driver(b, n, flat_args, row_lens=None):
            device = operand_device(kir, flat_args)
            bound = _wide(bind_operands(kir, b, n, flat_args, device))
            lens = (bind_row_lens(row_lens, b, n, device).reshape(b, 1)
                    if ragged else n)
            return list(fn((b, n), lens, device, *bound))

        return driver

    def build_reduction(self, kir) -> Callable:
        fn = self._compile(kir)
        multi = kir.meta_get("multi", False)
        neutrals = [(snippets.translate_expression(o["neutral"]),
                     canonical_dtype(o["dtype"])) for o in kir.outs]

        def driver(n, flat_args):
            device = operand_device(kir, flat_args)
            bound = _wide(bind_flat_operands(kir, n, flat_args, device))
            if n == 0:   # an empty stream folds to the neutral element
                outs = [torch.tensor(float(nt), device=device).to(dt)
                        for nt, dt in neutrals]
            else:
                outs = fn(n, device, *bound)
            return tuple(outs) if multi else outs[0]

        return driver

    def build_reduction_rows(self, kir) -> Callable:
        fn = self._compile(kir)
        ragged = bool(kir.meta_get("ragged", False))
        multi = kir.meta_get("multi", False)
        kinds = [kind for _, _, kind in kir.args]

        def driver(b, n, flat_args, row_lens=None):
            device = operand_device(kir, flat_args)
            bound = _wide(bind_operands(kir, b, n, flat_args, device))
            ncols, lens = n, n
            if ragged:
                # a row length past n reads the zero padding of the row's
                # bucket, as in the JAX package's padded blocks
                lens = bind_row_lens(row_lens, b, n, device).reshape(b, 1)
                ncols = dispatch.bucket_cols(n)
                bound = [F.pad(t, (0, ncols - n)) if k in ("full", "col")
                         else t for t, k in zip(bound, kinds)]
            outs = fn(b, ncols, lens, device, *bound)
            return tuple(outs) if multi else outs[0]

        return driver

    def build_scan(self, kir) -> Callable:
        fn = self._compile(kir)
        dt = canonical_dtype(kir.meta_get("dtype"))

        def driver(n, x):
            xf = _wide([torch.as_tensor(x).reshape(-1).to(dt)])[0]
            return fn(xf).to(dt) if n else xf.to(dt)

        return driver
