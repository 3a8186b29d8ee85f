"""Kernel IR — the transformation layer between specs and backends.

A copy of the JAX package's ``core/ir.py``: the IR does not depend on
the target.  A spec *lowers* into a small inspectable IR — an iteration
**domain** (axes with extents and parallel / sequential / reduction
tags), the **statements**, and the **argument access map** (name, dtype,
binding kind) — and a chain of pure transformations rewrites it before a
backend renders it.  One difference from the JAX package: the port's
statements and accumulator expressions hold the *untranslated C
snippet text*; each backend translates at render time (``eager`` to
torch, ``cuda`` to CUDA C).

Contracts:

  * every transformation is pure: it returns a NEW ``KernelIR`` plus an
    entry in ``transform_log`` — the input IR is never mutated;
  * ``cache_token()`` covers domain + statements + args + meta + the
    transformation log (plus ``IR_SCHEMA_VERSION``);
  * ``structural_token()`` drops the log — two transformation orders
    that reach the same IR compare equal structurally.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

#: Bumped whenever lowering or rendering semantics change: it feeds
#: ``cache.environment_fingerprint()``, so disk-cached drivers and
#: tuning winners from an older pipeline invalidate cleanly.
IR_SCHEMA_VERSION = 1

AXIS_TAGS = ("parallel", "sequential", "reduction")


@dataclass(frozen=True)
class Axis:
    """One iteration axis of the kernel domain.

    ``extent`` is the padded/bucketed static trip count (0 = not yet
    bound to a bucket — render-only IR).  ``block`` is the tile size a
    ``tile`` transformation assigned; the grid length along this axis
    is ``extent // block``.
    """

    name: str
    extent: int
    tag: str = "sequential"
    block: int | None = None

    def token(self) -> list:
        return [self.name, int(self.extent), self.tag,
                None if self.block is None else int(self.block)]


@dataclass(frozen=True)
class Statement:
    """One translated assignment.  ``kind`` orders render groups:
    ``prelude`` (hoisted CSE), ``body`` (elementwise lines), ``out``
    (accumulator descriptors rendered by the reduction templates)."""

    kind: str
    text: str

    def token(self) -> list:
        return [self.kind, self.text]


@dataclass(frozen=True)
class KernelIR:
    """A lowered kernel: domain + statements + access map + meta.

    ``args`` entries are ``(name, dtype_str, kind)`` with kind in
    scalar|full|row|col — the *access map* deciding how each operand
    binds to the domain (whole block, per-row, per-col, or (1,1)
    scalar).  ``outs`` is family-shaped: ``(name, dtype_str)`` pairs
    for elementwise, accumulator dicts (map_expr/neutral/reducer/
    combine/dtype) for reductions.  ``meta`` carries the family fields
    that don't fit the domain (needs_i, preamble, layout,
    multi, transposed, scan op descriptors ...).
    """

    kind: str                       # elementwise | reduction | scan
    name: str
    axes: tuple = ()
    args: tuple = ()                # ((name, dtype_str, kind), ...)
    statements: tuple = ()
    outs: tuple = ()
    meta: tuple = ()                # sorted ((key, value), ...) pairs
    transform_log: tuple = ()       # ((op, ((key, value), ...)), ...)

    # -- accessors -------------------------------------------------------
    def axis(self, name: str) -> Axis:
        for ax in self.axes:
            if ax.name == name:
                return ax
        raise KeyError(f"kernel {self.name!r} has no axis {name!r} "
                       f"(axes: {[a.name for a in self.axes]})")

    def meta_get(self, key: str, default=None):
        for k, v in self.meta:
            if k == key:
                return v
        return default

    def lines(self, kind: str) -> list[str]:
        return [s.text for s in self.statements if s.kind == kind]

    @property
    def transposed(self) -> bool:
        return bool(self.meta_get("transposed", False))

    # -- identity --------------------------------------------------------
    def structural_token(self) -> list:
        """Content identity of the IR itself, ignoring how it was
        reached — equal for any two transformation orders that produce
        the same kernel."""
        return [
            "ir", IR_SCHEMA_VERSION, self.kind, self.name,
            [ax.token() for ax in self.axes],
            [list(a) for a in self.args],
            [s.token() for s in self.statements],
            [sorted(o.items()) if isinstance(o, dict) else list(o)
             for o in self.outs],
            [list(kv) for kv in self.meta],
        ]

    def cache_token(self) -> list:
        """Full content identity: structure PLUS the transformation
        chain — what the dispatch cache and tuning store key on."""
        return self.structural_token() + [
            [[op, [list(kv) for kv in params]]
             for op, params in self.transform_log]]

    def cache_key(self) -> str:
        from repro_torch.core.cache import stable_hash
        return stable_hash(self.cache_token())

    def describe(self) -> str:
        """Human-readable dump: domain, access map, transformation log
        (the quickstart's plan-introspection hook)."""
        lines = [f"kernel {self.name} [{self.kind}]"]
        for ax in self.axes:
            blk = f" block={ax.block}" if ax.block else ""
            lines.append(f"  axis {ax.name}: extent={ax.extent} "
                         f"tag={ax.tag}{blk}")
        for name, dt, kind in self.args:
            lines.append(f"  arg  {name}: {dt} [{kind}]")
        for s in self.statements:
            lines.append(f"  {s.kind:7s} {s.text}")
        if self.transform_log:
            lines.append("  transforms:")
            for op, params in self.transform_log:
                ps = ", ".join(f"{k}={v}" for k, v in params)
                lines.append(f"    {op}({ps})")
        return "\n".join(lines)


def _meta_tuple(d: dict) -> tuple:
    return tuple(sorted(d.items()))


def _arg_tuple(arg_meta) -> tuple:
    from repro_torch.core.platform import dtype_name
    return tuple((m[0], dtype_name(m[1]), m[2]) for m in arg_meta)


# ----------------------------------------------------------- lowerings
def lower_elementwise(spec, *, rows: int, lanes: int,
                      layout: str = "flat", ragged: bool = False) -> KernelIR:
    """ElementwiseSpec -> IR.  ``layout='flat'`` is a lane tiling of a
    1-D stream; ``'rows'`` is the row-segmented (B, N) form where the
    lane axis spans one whole (bucketed) row.  ``ragged`` (rows layout
    only) adds a per-row runtime length operand ``_n`` masking each
    row's stores independently; the key is absent from dense IR so
    every pre-ragged token and render stays byte-identical."""
    from repro_torch.core.platform import dtype_name
    stmts = tuple(Statement("body", ln) for ln in spec.body_lines)
    outs = tuple((o, dtype_name(d))
                 for o, d in zip(spec.out_names, spec.out_dtypes))
    meta = {
        "layout": layout, "needs_i": bool(spec.needs_i),
        "scalar_names": tuple(spec.scalar_names),
        "loaded_vectors": tuple(spec.loaded_vectors),
        "preamble": spec.preamble,
    }
    if ragged:
        if layout != "rows":
            raise ValueError("ragged elementwise requires layout='rows'")
        meta["ragged"] = True
    return KernelIR(
        kind="elementwise", name=spec.name,
        axes=(Axis("rows", int(rows)), Axis("lanes", int(lanes))),
        args=_arg_tuple(spec.arg_meta),
        statements=stmts, outs=outs,
        meta=_meta_tuple(meta))


def lower_reduction(spec, *, rows: int, cols: int,
                    layout: str = "flat", ragged: bool = False) -> KernelIR:
    """ReductionSpec -> IR.  Flat: both axes sweep the masked stream
    (rows axis is the sequential grid accumulation).  Rows: the rows
    axis is the independent output axis, ``cols`` the reduced one.
    ``ragged`` (rows layout only) masks each row on a per-row runtime
    length vector instead of one shared ``n`` scalar; dense IR carries
    no key, keeping every pre-ragged token byte-identical."""
    stmts = tuple(Statement("prelude", ln) for ln in spec.prelude_lines)
    axes = (Axis("rows", int(rows),
                 tag="sequential" if layout == "flat" else "parallel"),
            Axis("lanes" if layout == "flat" else "cols", int(cols),
                 tag="reduction"))
    meta = {
        "layout": layout, "multi": bool(spec.multi),
        "axis": repr(spec.axis),
        "scalar_names": tuple(spec.scalar_names),
        "loaded_vectors": tuple(spec.loaded_vectors),
        "preamble": spec.preamble,
    }
    if ragged:
        if layout != "rows":
            raise ValueError("ragged reduction requires layout='rows'")
        meta["ragged"] = True
    return KernelIR(
        kind="reduction", name=spec.name,
        axes=axes, args=_arg_tuple(spec.arg_meta),
        statements=stmts, outs=tuple(dict(o) for o in spec.outs),
        meta=_meta_tuple(meta))


def lower_scan(spec, *, n: int) -> KernelIR:
    """ScanSpec -> IR over one sequential ``stream`` axis; a ``split``
    then factors it into (blocks x elements) for the two-pass form."""
    return KernelIR(
        kind="scan", name=spec.name,
        axes=(Axis("stream", int(n), tag="sequential"),),
        meta=_meta_tuple({
            "dtype": spec.dtype, "neutral": spec.neutral,
            "cumop": spec.cumop, "binop": spec.binop,
            "exclusive": bool(spec.exclusive),
        }))


# ----------------------------------------------------- transformations
def _logged(kir: KernelIR, op: str, **params) -> dict:
    return {"transform_log": kir.transform_log
            + ((op, tuple(sorted(params.items()))),)}


def _replace_axis(kir: KernelIR, name: str, *new: Axis) -> tuple:
    kir.axis(name)  # raise KeyError early on a bad axis name
    out = []
    for ax in kir.axes:
        out.extend(new if ax.name == name else [ax])
    return tuple(out)


def tile(kir: KernelIR, axis: str, block: int) -> KernelIR:
    """Block ``axis`` into tiles of ``block``: the grid steps over
    ``extent // block`` tiles.  Extents are pow2-bucketed so the split
    is always exact."""
    block = int(block)
    if block <= 0:
        raise ValueError(f"tile block must be positive, got {block}")
    ax = kir.axis(axis)
    axes = _replace_axis(kir, axis, replace(ax, block=block))
    return replace(kir, axes=axes, **_logged(kir, "tile",
                                             axis=axis, block=block))


def split(kir: KernelIR, axis: str, inner: int) -> KernelIR:
    """Factor ``axis`` (extent E) into ``axis.o`` (E // inner) outer x
    ``axis.i`` (inner) inner axes — the scan's blocks-x-elements
    decomposition.  The outer axis keeps the tag; the inner axis starts
    sequential until tagged."""
    inner = int(inner)
    ax = kir.axis(axis)
    if inner <= 0 or (ax.extent and ax.extent % inner):
        raise ValueError(f"cannot split axis {axis!r} (extent "
                         f"{ax.extent}) by {inner}")
    outer = Axis(f"{axis}.o", ax.extent // inner if ax.extent else 0,
                 tag=ax.tag)
    axes = _replace_axis(kir, axis, outer, Axis(f"{axis}.i", inner))
    return replace(kir, axes=axes, **_logged(kir, "split",
                                             axis=axis, inner=inner))


_SWAP = {"row": "col", "col": "row"}


def transpose_layout(kir: KernelIR) -> KernelIR:
    """Stored arrays are transposed relative to the iteration domain.

    This is the axis=0 column-reduction enabler: the domain stays
    (rows = independent outputs, cols = reduced), but full operands are
    bound with their two axes swapped and per-row / per-col broadcast
    kinds exchange roles.  Backends honor it at bind time (the driver
    transposes full operands into domain order); applying it twice
    returns to the identity layout."""
    args = tuple((n, d, _SWAP.get(k, k)) for n, d, k in kir.args)
    meta = dict(kir.meta)
    # involution: toggling back OFF removes the key entirely, so a
    # double application is structurally identical to the base IR
    if not meta.pop("transposed", False):
        meta["transposed"] = True
    return replace(kir, args=args, meta=_meta_tuple(meta),
                   **_logged(kir, "transpose_layout"))


def fuse_epilogue(kir: KernelIR, lines) -> KernelIR:
    """Append already-translated statements to the kernel body (before
    the stores) — how a planner epilogue rides a generated kernel
    instead of becoming its own launch."""
    lines = tuple(lines)
    extra = tuple(Statement("body", ln) for ln in lines)
    return replace(kir, statements=kir.statements + extra,
                   **_logged(kir, "fuse_epilogue", lines=lines))


def tag(kir: KernelIR, axis: str, tag_name: str) -> KernelIR:
    """Retag an axis.  Idempotent: retagging with the current tag
    returns the input IR unchanged (same object, no log entry)."""
    if tag_name not in AXIS_TAGS:
        raise ValueError(f"unknown axis tag {tag_name!r} "
                         f"(expected one of {AXIS_TAGS})")
    ax = kir.axis(axis)
    if ax.tag == tag_name:
        return kir
    axes = _replace_axis(kir, axis, replace(ax, tag=tag_name))
    return replace(kir, axes=axes, **_logged(kir, "tag",
                                             axis=axis, tag=tag_name))


def tag_parallel(kir: KernelIR, axis: str) -> KernelIR:
    return tag(kir, axis, "parallel")


#: transformation registry — how serialized winner sequences
#: (autotune / warm-start manifest) replay onto an IR
TRANSFORMS = {
    "tile": tile,
    "split": split,
    "transpose_layout": transpose_layout,
    "fuse_epilogue": fuse_epilogue,
    "tag": tag,
    "tag_parallel": tag_parallel,
}


def apply_sequence(kir: KernelIR, sequence) -> KernelIR:
    """Replay a serialized transformation sequence
    ``((op, {param: value, ...}), ...)`` onto an IR."""
    for op, params in sequence:
        kir = TRANSFORMS[op](kir, **dict(params))
    return kir
