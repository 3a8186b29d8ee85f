"""EagerBackend — the snippets as plain torch operations.

The counterpart of the JAX package's ``XlaBackend``: the kernel IR
renders to torch code over whole row blocks — masked segment reductions
(``torch.amax`` / ``torch.sum`` along the rows) with the same ``_acc<k>``
chaining, broadcast epilogues, and ``cumsumf`` as ``torch.cumsum`` —
exec'd through `SourceModule`, so generated code stays introspectable.
Tiled axes are ignored (there is no grid), and the operands keep their
exact ``(b, n)`` shape: nothing in the code depends on the bucket, which
is why this backend is ``block_sensitive = False``.

It is the plain version of the ``cuda`` backend's kernels: the CPU
tests run it against the JAX package, and the chip check holds every
CUDA kernel against it on the same card tensors.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import snippets
from repro_torch.core.backends.base import (Backend, bind_operands,
                                            bind_row_lens, operand_device)
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
    _acc{{ loop.index0 }} = {{ o.fold }}(_mapped{{ loop.index0 }}, dim=1, keepdim=True).to(torch.{{ o.dtype }})
{% endfor %}
    return ({% for o in outs %}_acc{{ loop.index0 }}[:, 0], {% endfor %})
''',
)

# Rows elementwise: the statements over the whole (b, n) block, written
# vectors kept in locals (in-place semantics); the ragged form zeroes
# every output past its row's length.
_ELTWISE_TMPL = KernelTemplate(
    "eager_eltwise_rows",
    '''
def {{ name }}_fn(_b, _ncols, _n, _dev{% for a in in_names %}, {{ a }}{% endfor %}):
    _BLK = (_b, _ncols)
{% for line in body_lines %}
    {{ line }}
{% endfor %}
{% if ragged %}
    _keep = torch.arange(_ncols, device=_dev).reshape(1, _ncols) < _n
{% for o in out_names %}
    {{ o }} = torch.where(_keep, {{ o }}, torch.zeros((), dtype={{ o }}.dtype, device=_dev))
{% endfor %}
{% endif %}
    return ({% for o in out_names %}{{ o }}, {% endfor %})
''',
)

#: target-neutral reducer -> torch fold along the row
_FOLDS = {"sum": "torch.sum", "prod": "torch.prod", "max": "torch.amax",
          "min": "torch.amin"}


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
                ragged=kir.meta_get("ragged", False))
        elif kir.kind == "reduction":
            outs = [dict(o, map_expr=snippets.translate_expression(o["map_expr"]),
                         neutral=snippets.translate_expression(o["neutral"]),
                         fold=_FOLDS[o["reducer"]]) for o in kir.outs]
            src = _ROW_REDUCE_TMPL.render(
                name=kir.name,
                in_names=[a[0] for a in kir.args],
                prelude_lines=[snippets.translate_assignment(s)
                               for s in kir.lines("prelude")],
                outs=outs)
        else:
            raise ValueError(f"unknown IR kind {kir.kind!r}")
        return _with_preamble(kir.meta_get("preamble", ""), src)

    def _compile(self, kir) -> Callable:
        return SourceModule.load(self.render_ir(kir), name=kir.name) \
            .get_function(f"{kir.name}_fn")

    # -- drivers -----------------------------------------------------------
    def build_elementwise_rows(self, kir) -> Callable:
        fn = self._compile(kir)
        ragged = bool(kir.meta_get("ragged", False))

        def driver(b, n, flat_args, row_lens=None):
            device = operand_device(kir, flat_args)
            bound = bind_operands(kir, b, n, flat_args, device)
            lens = (bind_row_lens(row_lens, b, n, device).reshape(b, 1)
                    if ragged else n)
            return list(fn(b, n, lens, device, *bound))

        return driver

    def build_reduction_rows(self, kir) -> Callable:
        fn = self._compile(kir)
        ragged = bool(kir.meta_get("ragged", False))
        multi = kir.meta_get("multi", False)

        def driver(b, n, flat_args, row_lens=None):
            device = operand_device(kir, flat_args)
            bound = bind_operands(kir, b, n, flat_args, device)
            lens = (bind_row_lens(row_lens, b, n, device).reshape(b, 1)
                    if ragged else n)
            outs = fn(b, n, lens, device, *bound)
            return tuple(outs) if multi else outs[0]

        return driver
