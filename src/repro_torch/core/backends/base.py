"""The Backend contract — one RTCG pipeline, pluggable execution targets.

The source paper's architectural claim is that a run-time code-generation
pipeline splits into a *target-independent* front half (snippets,
caching, planning) and a *target-specific* back half (compile and
launch) — PyCUDA and PyOpenCL share everything but the last step.  The
port keeps the JAX package's split:

  * the kernel families (`elementwise` / `reduction` / `scan`) produce
    **specs** — frozen descriptions of the *untranslated C snippets*
    plus argument metadata;
  * the specs lower into the kernel IR (`repro_torch.core.ir`) and a
    chain of pure transformations schedules it — that pipeline lives
    HERE, in the concrete ``*_driver`` methods, shared by every backend;
  * a `Backend` turns the transformed IR into a *driver*: ``render_ir``
    (IR -> source text, translating the C snippets for its target) and
    ``build_*`` (the driver: bind operands, launch, return outputs).

Drivers keep the JAX package's calling conventions:

  * flat elementwise/reduction: ``driver(n, flat_args)``;
  * row-segmented (axis=-1):    ``driver(b, n, flat_args, row_lens=None)``;
  * column-segmented (axis=0):  ``driver(b, n, flat_args)`` over the
    *domain* geometry (b = outputs, n = reduced length) with operands in
    storage order — the IR's ``transpose_layout`` tells the backend to
    bind full operands transposed (a strided view, never a copy);
  * scan:                       ``driver(n, x)``.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.platform import (LANES, bind_flat_operand,
                                       bind_row_operand, canonical_dtype)


@dataclass(frozen=True)
class ElementwiseSpec:
    """Snippet + argument description of one elementwise kernel.

    ``body_lines`` are the *C* statements of the snippet, untranslated
    (each backend translates them for its target at render time).
    ``arg_meta`` is ``(name, torch dtype, kind)`` per positional argument
    with kind in scalar|full|row|col.  ``needs_i``: the snippet reads
    the flat element index ``i`` (flat layout only).
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
    and ``b``) and ``dtype``.  ``axis`` is None (flat: one scalar per
    accumulator), -1 (row-segmented: one accumulator per row; later map
    expressions may reference earlier accumulators as ``_acc<k>``) or 0
    (column-segmented: the same segmented kernel over the transposed
    layout; arg kinds stay in STORAGE orientation).
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


@dataclass(frozen=True)
class ScanSpec:
    """Description of one prefix scan.  ``cumop`` names the fold (sum |
    prod | max | min), ``binop`` is its C combine of ``a`` and ``b``,
    ``neutral`` a C literal; inclusive results fold the neutral in once
    (``binop(scan(x), neutral)``), as the JAX package's carries do."""

    name: str
    dtype: str                 # dtype name, e.g. "float32"
    neutral: str
    cumop: str
    binop: str
    exclusive: bool

    def token(self) -> list:
        return ["scan", self.name, self.dtype, self.neutral, self.cumop,
                self.binop, self.exclusive]


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
    def elementwise_driver(self, spec: ElementwiseSpec, *, bucket: int,
                           block_rows: int) -> Callable:
        """Compile one flat-layout driver: ``driver(n, flat_args) ->
        [flat outputs]`` serving every ``n`` whose rows fit ``bucket``."""
        from repro_torch.core import ir

        kir = ir.lower_elementwise(spec, rows=bucket, lanes=LANES)
        kir = ir.tag_parallel(kir, "rows")
        kir = ir.tile(kir, "rows", block_rows)
        return self.build_elementwise(kir)

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

    def reduction_driver(self, spec: ReductionSpec, *, bucket: int,
                         block_rows: int) -> Callable:
        """Compile one flat map+reduce driver: ``driver(n, flat_args)``
        returning a 0-d tensor (a tuple of them when ``spec.multi``).
        The rows axis stays SEQUENTIAL, as in the JAX package's IR."""
        from repro_torch.core import ir

        kir = ir.lower_reduction(spec, rows=bucket, cols=LANES)
        kir = ir.tile(kir, "rows", block_rows)
        return self.build_reduction(kir)

    def reduction_rows_driver(self, spec: ReductionSpec, *, brows: int,
                              ncols: int, block_rows: int,
                              ragged: bool = False) -> Callable:
        """Compile one segmented driver: ``driver(b, n, flat_args,
        row_lens=None)`` returning ``(b,)`` outputs (a tuple when
        ``spec.multi``).  ``brows``/``ncols`` are DOMAIN buckets; for
        ``spec.axis == 0`` the domain is the transpose of the stored
        arrays, so ``transpose_layout`` joins the chain.  ``ragged=True``
        replaces the shared row length ``n`` with a per-row length vector
        (axis=-1 only)."""
        from repro_torch.core import ir

        if ragged and spec.axis == 0:
            raise ValueError("ragged reduction is axis=-1 only "
                             "(axis=0 reduces across the stored rows)")
        kir = ir.lower_reduction(spec, rows=brows, cols=ncols,
                                 layout="rows", ragged=ragged)
        if spec.axis == 0:
            kir = ir.transpose_layout(kir)
        kir = ir.tag_parallel(kir, "rows")
        kir = ir.tile(kir, "rows", block_rows)
        return self.build_reduction_rows(kir)

    def scan_driver(self, spec: ScanSpec, *, grid: int,
                    block_n: int) -> Callable:
        """Compile one prefix-scan driver: ``driver(n, x) -> flat out``.
        The stream axis splits into (blocks x elements); the inner axis
        is parallel within a block, the outer carries the prefix."""
        from repro_torch.core import ir

        kir = ir.lower_scan(spec, n=grid * block_n)
        kir = ir.split(kir, "stream", block_n)
        kir = ir.tag_parallel(kir, "stream.i")
        return self.build_scan(kir)

    # =========================== backend obligations (IR in, code out)
    @abc.abstractmethod
    def render_ir(self, kir) -> str:
        """Render a transformed `KernelIR` to source text."""

    @abc.abstractmethod
    def build_elementwise(self, kir) -> Callable:
        """Assemble the flat elementwise driver from a tiled IR."""

    @abc.abstractmethod
    def build_elementwise_rows(self, kir) -> Callable:
        """Assemble the row-layout elementwise driver from a tiled IR."""

    @abc.abstractmethod
    def build_reduction(self, kir) -> Callable:
        """Assemble the flat map+reduce driver from a tiled IR."""

    @abc.abstractmethod
    def build_reduction_rows(self, kir) -> Callable:
        """Assemble the segmented reduction driver from a tiled IR
        (honouring ``kir.transposed`` at operand-bind time)."""

    @abc.abstractmethod
    def build_scan(self, kir) -> Callable:
        """Assemble the prefix-scan driver from a split IR."""


# ------------------------------------------------- shared operand binding
def operand_device(kir, flat_args) -> torch.device:
    """Device of the leading full operand (numpy input counts as CPU)."""
    for (_, _, kind), a in zip(kir.args, flat_args):
        if kind == "full":
            return a.device if isinstance(a, torch.Tensor) \
                else torch.device("cpu")
    raise ValueError(f"kernel {kir.name!r} has no full vector operand")


def check_arity(kir, flat_args) -> None:
    if len(flat_args) != len(kir.args):
        raise TypeError(f"kernel {kir.name!r} takes {len(kir.args)} "
                        f"arguments, got {len(flat_args)}")


def bind_operand(kir, kind: str, name: str, arg, dt, b: int, n: int,
                 device):
    """Bind one rows-form operand in DOMAIN order (see
    `platform.bind_row_operand`): a transposed (axis=0) full operand is
    bound in its storage order ``(n, b)`` and handed on as the
    transposed ``(b, n)`` view, so no copy is made."""
    dt = canonical_dtype(dt)
    if kir.transposed and kind == "full":
        return bind_row_operand(kind, name, arg, dt, n, b, device).t()
    return bind_row_operand(kind, name, arg, dt, b, n, device)


def bind_operands(kir, b: int, n: int, flat_args, device) -> list:
    """Bind every positional operand of a rows-form kernel."""
    check_arity(kir, flat_args)
    return [bind_operand(kir, kind, name, arg, dt, b, n, device)
            for (name, dt, kind), arg in zip(kir.args, flat_args)]


def bind_flat_operands(kir, n: int, flat_args, device) -> list:
    """Bind every positional operand of a flat-layout kernel (see
    `platform.bind_flat_operand`)."""
    check_arity(kir, flat_args)
    return [bind_flat_operand(kind, name, arg, canonical_dtype(dt), n,
                              device)
            for (name, dt, kind), arg in zip(kir.args, flat_args)]


def bind_row_lens(row_lens, b: int, n: int, device) -> torch.Tensor:
    """The ragged form's ``(b,)`` int32 per-row length operand."""
    return bind_row_operand("row", "row_lens", row_lens, torch.int32, b, n,
                            device).reshape(b)
