"""The Backend contract — one RTCG pipeline, pluggable execution targets.

The source paper's architectural claim is that a run-time code-generation
pipeline splits into a *target-independent* front half (snippets,
caching, planning) and a *target-specific* back half (compile and
launch) — PyCUDA and PyOpenCL share everything but the last step.  The
port keeps the JAX package's split:

  * the kernel families (`elementwise` / `reduction`) produce **specs**
    — frozen descriptions of the *untranslated C snippets* plus argument
    metadata;
  * the specs lower into the kernel IR (`repro_torch.core.ir`) and a
    chain of pure transformations schedules it — that pipeline lives
    HERE, in the concrete ``*_driver`` methods, shared by every backend;
  * a `Backend` turns the transformed IR into a *driver*: ``render_ir``
    (IR -> source text, translating the C snippets for its target) and
    ``build_*`` (the driver: bind operands, launch, return outputs).

Drivers keep the JAX package's calling convention for the rows forms:
``driver(b, n, flat_args, row_lens=None)``.  The flat forms and scans
are not ported yet (ROADMAP Queue 2, items 3-5).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.platform import bind_row_operand, canonical_dtype


@dataclass(frozen=True)
class ElementwiseSpec:
    """Snippet + argument description of one elementwise kernel.

    ``body_lines`` are the *C* statements of the snippet, untranslated
    (each backend translates them for its target at render time).
    ``arg_meta`` is ``(name, torch dtype, kind)`` per positional argument
    with kind in scalar|full|row|col.
    """

    name: str
    arg_meta: tuple            # ((name, dtype, kind), ...)
    scalar_names: tuple
    loaded_vectors: tuple      # vector/broadcast names read by the body
    body_lines: tuple
    out_names: tuple
    out_dtypes: tuple
    needs_i: bool
    preamble: str = ""

    def token(self) -> list:
        """JSON-able identity for content-addressed caching."""
        return ["eltwise", self.name,
                [(m[0], str(m[1]), m[2]) for m in self.arg_meta],
                list(self.body_lines), list(self.out_names),
                [str(d) for d in self.out_dtypes], self.needs_i,
                self.preamble]


@dataclass(frozen=True)
class ReductionSpec:
    """Snippet + argument description of one (multi-accumulator) map+reduce.

    ``outs`` holds one dict per accumulator, all C text: ``map_expr``,
    ``neutral`` (literal), ``reducer`` (sum | prod | max | min — what a
    backend folds with), ``combine`` (the C combine expression of ``a``
    and ``b``) and ``dtype``.  ``axis`` is -1 (row-segmented: one
    accumulator per row; later map expressions may reference earlier
    accumulators as ``_acc<k>``).
    """

    name: str
    arg_meta: tuple
    scalar_names: tuple
    loaded_vectors: tuple
    prelude_lines: tuple       # hoisted CSE assignments, C text
    outs: tuple                # (dict(map_expr, neutral, reducer, combine, dtype), ...)
    multi: bool
    axis: Any = -1
    preamble: str = ""

    def token(self) -> list:
        return ["reduce", self.name,
                [(m[0], str(m[1]), m[2]) for m in self.arg_meta],
                list(self.prelude_lines),
                [sorted(o.items()) for o in self.outs],
                self.multi, repr(self.axis), self.preamble]


class Backend(abc.ABC):
    """One execution target of the RTCG pipeline (lower -> render ->
    launch).  Concrete backends are stateless singletons; compiled
    drivers are cached by the dispatch engine under backend-qualified
    keys, so two backends never share or clobber each other's drivers.
    """

    #: registry name; also the tag on dispatch counters
    name: str = "abstract"

    #: whether ``block_rows`` changes the *generated code*.  Neither port
    #: backend's code depends on it (the CUDA kernels take ``b``/``n`` at
    #: run time), so it drops out of the dispatch keys.
    block_sensitive: bool = False

    @abc.abstractmethod
    def fingerprint(self) -> dict:
        """Capability/version record; differs between any two backends."""

    # ================= shared lowering pipeline (spec -> IR -> build)
    def elementwise_rows_driver(self, spec: ElementwiseSpec, *, brows: int,
                                ncols: int, block_rows: int,
                                ragged: bool = False) -> Callable:
        """Compile one row-layout driver: ``driver(b, n, flat_args,
        row_lens=None) -> [(b, n) outputs]`` serving every ``(B, N)`` in
        the bucket pair.  ``ragged=True`` masks each row's stores at its
        own length (columns past it come back as zeros)."""
        from repro_torch.core import ir

        kir = ir.lower_elementwise(spec, rows=brows, lanes=ncols,
                                   layout="rows", ragged=ragged)
        kir = ir.tag_parallel(kir, "rows")
        kir = ir.tile(kir, "rows", block_rows)
        return self.build_elementwise_rows(kir)

    def reduction_rows_driver(self, spec: ReductionSpec, *, brows: int,
                              ncols: int, block_rows: int,
                              ragged: bool = False) -> Callable:
        """Compile one segmented driver: ``driver(b, n, flat_args,
        row_lens=None)`` returning ``(b,)`` outputs (a tuple when
        ``spec.multi``).  ``ragged=True`` replaces the shared row length
        ``n`` with a per-row length vector."""
        from repro_torch.core import ir

        kir = ir.lower_reduction(spec, rows=brows, cols=ncols,
                                 layout="rows", ragged=ragged)
        kir = ir.tag_parallel(kir, "rows")
        kir = ir.tile(kir, "rows", block_rows)
        return self.build_reduction_rows(kir)

    # =========================== backend obligations (IR in, code out)
    @abc.abstractmethod
    def render_ir(self, kir) -> str:
        """Render a transformed `KernelIR` to source text."""

    @abc.abstractmethod
    def build_elementwise_rows(self, kir) -> Callable:
        """Assemble the row-layout elementwise driver from a tiled IR."""

    @abc.abstractmethod
    def build_reduction_rows(self, kir) -> Callable:
        """Assemble the segmented reduction driver from a tiled IR."""

    def build_elementwise(self, kir) -> Callable:
        raise NotImplementedError(
            "flat-layout elementwise kernels are ported with ROADMAP "
            "Queue 2 item 3 (pallas.py:268)")

    def build_reduction(self, kir) -> Callable:
        raise NotImplementedError(
            "flat reductions are ported with ROADMAP Queue 2 item 4 "
            "(pallas.py:349)")

    def build_scan(self, kir) -> Callable:
        raise NotImplementedError(
            "prefix scans are ported with ROADMAP Queue 2 item 5 "
            "(pallas.py:441, :446)")


# ------------------------------------------------- shared operand binding
def operand_device(kir, flat_args) -> torch.device:
    """Device of the leading full operand (numpy input counts as CPU)."""
    for (_, _, kind), a in zip(kir.args, flat_args):
        if kind == "full":
            return a.device if isinstance(a, torch.Tensor) \
                else torch.device("cpu")
    raise ValueError(f"kernel {kir.name!r} has no full vector operand")


def bind_operands(kir, b: int, n: int, flat_args, device) -> list:
    """Bind every positional operand of a rows-form kernel (see
    `platform.bind_row_operand`)."""
    if len(flat_args) != len(kir.args):
        raise TypeError(f"kernel {kir.name!r} takes {len(kir.args)} "
                        f"arguments, got {len(flat_args)}")
    return [bind_row_operand(kind, name, arg, canonical_dtype(dt), b, n,
                             device)
            for (name, dt, kind), arg in zip(kir.args, flat_args)]


def bind_row_lens(row_lens, b: int, n: int, device) -> torch.Tensor:
    """The ragged form's ``(b,)`` int32 per-row length operand."""
    return bind_row_operand("row", "row_lens", row_lens, torch.int32, b, n,
                            device).reshape(b)
