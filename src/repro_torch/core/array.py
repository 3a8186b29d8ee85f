"""RTCGArray — the GPUArray analogue with *lazy expression fusion* (paper §5.2.1).

PyCUDA's GPUArray executes one kernel per operator, and the paper points
out that ElementwiseKernel exists precisely to beat "the common problem
of proliferation of temporary variables plaguing abstract,
operator-overloading array packages".  The port closes that loop as the
JAX package does: RTCGArray operators build an expression DAG;
evaluation walks the DAG and emits fused generated kernels through the
same RTCG machinery (`ElementwiseKernel`, `ReductionKernel`),
content-cached by DAG structure, so

    x, y = to_gpu(xh), to_gpu(yh)          # tensors on the card
    z = (5 * x + 6 * y).evaluate()         # ONE generated kernel

The **fusion planner** reaches across the map/reduce boundary and is
**axis-aware**: ``.sum/.max/.min/.mean`` take ``axis`` in {None, -1, 0}
(``axis=-1``/``0`` over 2-D operands return ``(B,)``/``(N,)`` lazy
``reduce`` nodes), so

    softmax = x.exp() / x.exp().sum(axis=-1)   # batched: (B, N) rows
    rms     = x / ((x * x).mean(axis=-1) + eps).sqrt() * w

schedule as ONE segmented `ReductionKernel` launch plus ONE fused
`ElementwiseKernel` epilogue in the 2-D row layout.  ``axis=0`` rides
the same machinery through the IR's ``transpose_layout``.

Scheduling (`plan_many`) emits a *minimal launch schedule*:

  * reduce nodes are partitioned into dependency **waves**; each wave is
    ONE multi-accumulator `ReductionKernel` launch (sibling reductions
    share one pass).  Segmented waves group per ``(geometry, axis)``, and
    a segmented reduction depending on a *sibling* of the same geometry
    joins the same wave: the dependency resolves in-kernel
    (``_acc<k>``), which keeps stable softmax's max and shifted-exp sum
    in one launch;
  * computed reductions re-enter later snippets as positional args:
    scalar reductions as ``s<j>`` scalar args, segmented ones as
    ``r<j>`` per-row (axis=-1) or per-col (axis=0) `BroadcastArg`s;
  * every vector-valued root fuses into ONE epilogue `ElementwiseKernel`
    per output geometry; leaves of unequal length broadcast inside it
    (``(B, 1)`` per-row, ``(N,)`` per-col, 1-element as scalar args);
  * repeated subtrees across the snippets of one generated kernel are
    hoisted into named temporaries (``_t<k>``) — common-subexpression
    sharing;
  * roots that are pure scalar/row arithmetic over reduced values (the
    ``/ n`` of ``.mean()``) fold outside any generated kernel (one torch
    op on the reduced value's device): zero extra generated launches.

Plans are **dtype-faithful** (the JAX package's promotion rules with
x64 off: a Python float promotes an integer chain to float32, a Python
int keeps it), max/min neutrals come from ``torch.finfo``/``iinfo`` of
the plan dtype, and generated kernels are content-cached on DAG
structure × dtypes × arg kinds (never scalar values) in bounded
`LRUCache`s of 128 entries each.

What the JAX package adds and the port does not have yet raises
`NotImplementedError` naming its ROADMAP item: ``backend="auto"``, the
degradation ladder and its circuit breaker (Queue 1 item 2), and
autotuning (Queue 1 item 6).  An evaluation plans and launches on ONE
resolved backend — ``cuda`` for tensors on the card, ``eager`` for CPU
tensors — and a build or launch failure raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core import backends as _backends
from repro_torch.core import snippets
from repro_torch.core.cache import LRUCache, stable_hash
from repro_torch.core.elementwise import ElementwiseKernel
from repro_torch.core.platform import (BroadcastArg, ScalarArg, VectorArg,
                                       resolve_device)
from repro_torch.core.platform import canonical_dtype as _canonical
from repro_torch.core.reduction import ReductionKernel

_UNARY_FUNCS = {
    "exp": "expf", "log": "logf", "sqrt": "sqrtf", "abs": "fabsf",
    "sin": "sinf", "cos": "cosf", "tanh": "tanhf", "sigmoid": "sigmoid",
}

# Unary ops whose result is floating even over integer operands.
_FLOAT_FUNCS = {"exp", "log", "sqrt", "sin", "cos", "tanh", "sigmoid"}

# Reduction kinds: kind -> C reduce_expr; neutrals are dtype-derived.
_REDUCE_EXPRS = {"sum": "a+b", "max": "fmaxf(a,b)", "min": "fminf(a,b)"}

_FUSION_CACHE_SIZE = 128
_kernel_cache: LRUCache = LRUCache(maxsize=_FUSION_CACHE_SIZE)
_reduce_cache: LRUCache = LRUCache(maxsize=_FUSION_CACHE_SIZE)

_LADDER = ("the degradation ladder and its circuit breaker are ported with "
           "ROADMAP Queue 1 item 2")
_AUTO = ("backend='auto' (the latency router) is ported with ROADMAP "
         "Queue 1 item 2")
_TUNE = ("autotuning generated kernels (an H100 cost model or a "
         "wall-clock tuner) is ported with ROADMAP Queue 1 item 6")


def _result_type(parts) -> torch.dtype:
    """The JAX package's ``jnp.result_type`` over array dtypes and Python
    scalars (weakly typed): arrays promote among themselves; a Python
    float makes a non-float result float32, a Python int makes a bool
    result int32; the JAX x64-off rule then canonicalizes."""
    dts = [p for p in parts if isinstance(p, torch.dtype)]
    scalars = [p for p in parts if not isinstance(p, torch.dtype)]
    if dts:
        dt = dts[0]
        for d in dts[1:]:
            dt = torch.promote_types(dt, d)
    else:
        dt = torch.bool if all(isinstance(s, bool) for s in scalars) else \
            torch.int32 if all(isinstance(s, (bool, int)) for s in scalars) \
            else torch.float32
    for s in scalars:
        if isinstance(s, float) and not dt.is_floating_point:
            dt = torch.float32
        elif isinstance(s, int) and not isinstance(s, bool) \
                and dt == torch.bool:
            dt = torch.int32
    return _canonical(dt)


def _neutral_for(kind: str, dtype) -> str:
    """Neutral-element literal for a reduction over ``dtype``, from
    ``finfo``/``iinfo`` of the *plan* dtype (a float32-ish ``-3.0e38``
    overflows integer dtypes)."""
    if kind == "sum":
        return "0"
    dt = _canonical(dtype)
    if dt.is_floating_point:
        info = torch.finfo(dt)
        return repr(float(info.min if kind == "max" else info.max))
    info = torch.iinfo(dt)
    return str(int(info.min if kind == "max" else info.max))


class _Expr:
    """Expression DAG node.  Leaves hold concrete tensors or scalars.

    ``reduce`` nodes (``value`` names the kind: sum/max/min) are interior
    nodes: ``axis is None`` plans a full (scalar) reduction, ``axis ==
    -1`` a per-row reduction over the chain's last dimension, ``axis ==
    0`` a per-column one over a 2-D chain.
    """

    def __init__(self, op: str, children: tuple = (), value: Any = None,
                 axis: int | None = None):
        self.op = op  # 'leaf' | 'scalar' | 'reduce' | '+','-','*','/','**' | unary
        self.children = children
        self.value = value
        self.axis = axis


# ------------------------------------------------------------ DAG walkers
def _dtype_of(expr: _Expr) -> torch.dtype:
    """Plan dtype: `_result_type` over every leaf dtype and embedded
    scalar in the (sub)tree — reduce nodes are transparent — with float
    promotion when a transcendental sits anywhere in the chain."""
    parts: list = []
    floaty = False

    def walk(e: _Expr) -> None:
        nonlocal floaty
        if e.op == "leaf":
            parts.append(e.value.dtype)
            return
        if e.op == "scalar":
            parts.append(e.value)
            return
        if e.op in _FLOAT_FUNCS:
            floaty = True
        for c in e.children:
            walk(c)

    walk(expr)
    if not parts:
        raise ValueError("expression has no array leaves")
    dt = _result_type(parts)
    if floaty:
        dt = torch.promote_types(dt, torch.float32)
    return _canonical(dt)


def _first_leaf(expr: _Expr):
    """The first concrete tensor of the DAG (decides its device)."""
    if expr.op == "leaf":
        return expr.value
    for c in expr.children:
        leaf = _first_leaf(c)
        if leaf is not None:
            return leaf
    return None


def _bshape(expr: _Expr) -> tuple:
    """Broadcast shape of a node: a segmented reduction contributes its
    chain shape with the reduced dim collapsed to 1 (keepdims)."""
    if expr.op == "leaf":
        return tuple(expr.value.shape)
    if expr.op == "scalar":
        return ()
    if expr.op == "reduce":
        if expr.axis is None:
            return ()
        child = _bshape(expr.children[0])
        if expr.axis == 0:  # column reduce: keepdims over the batch dim
            return child[:-2] + (1,) + child[-1:]
        return child[:-1] + (1,)
    return tuple(np.broadcast_shapes(*[_bshape(c) for c in expr.children]))


def _outer_segmented_axes(expr: _Expr) -> set:
    """Axes of segmented reductions reachable without crossing another
    reduction."""
    if expr.op == "reduce":
        return set() if expr.axis is None else {expr.axis}
    out: set = set()
    for c in expr.children:
        out |= _outer_segmented_axes(c)
    return out


def _shape_of(expr: _Expr) -> tuple:
    """User-visible shape: segmented reductions produce vector results
    (no keepdims) — ``(B,)`` for axis=-1, ``(N,)`` for axis=0."""
    s = _bshape(expr)
    if s and not _vector_outside_reduce(expr):
        axes = _outer_segmented_axes(expr)
        if axes == {-1} and s[-1] == 1:
            return s[:-1]
        if axes == {0} and len(s) >= 2 and s[-2] == 1:
            return s[:-2] + s[-1:]
    return s


def _row_geometry(bshape: tuple) -> tuple[int, int]:
    """Collapse a >=2-D broadcast shape to (batch rows, row length)."""
    lead = 1
    for d in bshape[:-1]:
        lead *= int(d)
    return (max(1, lead), int(bshape[-1]))


def _has_reduce(expr: _Expr) -> bool:
    if expr.op == "reduce":
        return True
    return any(_has_reduce(c) for c in expr.children)


def _interior_reduce_ids(expr: _Expr) -> set:
    """ids of every reduce node in the subtree (the root included)."""
    out: set = set()

    def walk(e: _Expr) -> None:
        if e.op == "reduce":
            out.add(id(e))
        for c in e.children:
            walk(c)

    walk(expr)
    return out


def _vector_outside_reduce(expr: _Expr) -> bool:
    """True if the expression reads a vector leaf *outside* any reduction
    (evaluating it needs an elementwise launch)."""
    if expr.op == "leaf":
        return True
    if expr.op in ("scalar", "reduce"):
        return False
    return any(_vector_outside_reduce(c) for c in expr.children)


def _leaf_kind(arr, b: int, n: int) -> str:
    """Classify a leaf against the plan geometry ``(b, n)``: 'full',
    'row' ``(B, 1)``, 'col' ``(N,)``/``(1, N)`` or 'scalar' (1 element)."""
    shape = tuple(int(d) for d in arr.shape)
    size = 1
    for d in shape:
        size *= d
    if size <= 1:
        return "scalar"
    if size == b * n:
        return "full"
    if len(shape) >= 2 and shape[-1] == 1 and size == b:
        return "row"
    if size == n and (len(shape) == 1 or shape[-1] == n):
        return "col"
    raise ValueError(
        f"leaf of shape {shape} does not broadcast against plan geometry "
        f"({b}, {n}); supported: full, (B, 1) per-row, (N,) per-col, "
        f"1-element scalar")


class _Serializer:
    """Shared serialization state for every snippet of ONE generated
    kernel: positional argument slots plus structural common-
    subexpression elimination.

    Slots: concrete leaves -> ``v<j>`` (dedup by identity), embedded
    Python numbers and computed *scalar* reductions -> ``s<j>``, computed
    segmented reductions -> ``r<j>`` broadcast args (per-row ``(B, 1)``
    for axis=-1, per-col ``(1, N)`` for axis=0).  Reduce nodes listed in
    ``local_nodes`` (same segmented wave) serialize to ``_acc<k>``.

    CSE: a `count` pass tallies structurally identical subtrees across
    all roots; `emit` serializes a subtree seen >= 2 times once into a
    ``_t<k>`` prelude statement and references it by name afterwards.
    """

    def __init__(self, allow_reduce: bool = False, local_nodes: tuple = (),
                 cse: bool = True):
        self.allow_reduce = allow_reduce
        self.local = {id(n): j for j, n in enumerate(local_nodes)}
        self.cse = cse
        self.leaves: list = []
        self.scalars: list = []
        self.scalar_dtypes: list = []
        self.bvecs: list = []
        self.bvec_dtypes: list = []
        self.bvec_kinds: list = []   # "row" (axis=-1) | "col" (axis=0)
        self.prelude: list = []
        self._counts: dict = {}
        self._skeys: dict = {}
        self._temps: dict = {}

    def _skey(self, e: _Expr):
        k = self._skeys.get(id(e))
        if k is None:
            if e.op == "leaf":
                k = ("leaf", id(e.value))
            elif e.op == "scalar":
                k = ("scalar", repr(e.value))
            elif e.op == "reduce":
                k = ("reduce", id(e))
            else:
                k = (e.op,) + tuple(self._skey(c) for c in e.children)
            self._skeys[id(e)] = k
        return k

    def count(self, e: _Expr) -> None:
        if not self.cse:
            return
        k = self._skey(e)
        c = self._counts.get(k, 0) + 1
        self._counts[k] = c
        # don't descend into repeats: nested subtrees of a hoisted parent
        # serialize once inside the temp
        if c == 1 and e.op not in ("leaf", "scalar", "reduce"):
            for ch in e.children:
                self.count(ch)

    def _has_local_reduce(self, e: _Expr) -> bool:
        if e.op == "reduce" and id(e) in self.local:
            return True
        return any(self._has_local_reduce(c) for c in e.children)

    def emit(self, e: _Expr) -> str:
        k = self._skey(e)
        hoist = (self.cse and e.op not in ("leaf", "scalar", "reduce")
                 and self._counts.get(k, 0) >= 2
                 and not self._has_local_reduce(e))
        if hoist and k in self._temps:
            return self._temps[k]
        s = self._emit_node(e)
        if hoist:
            name = f"_t{len(self._temps)}"
            self._temps[k] = name
            self.prelude.append(f"{name} = {s}")
            return name
        return s

    def _emit_node(self, e: _Expr) -> str:
        if e.op == "leaf":
            for j, a in enumerate(self.leaves):
                if a is e.value:
                    return f"v{j}[i]"
            self.leaves.append(e.value)
            return f"v{len(self.leaves) - 1}[i]"
        if e.op == "scalar":
            self.scalars.append(e.value)
            self.scalar_dtypes.append(None)  # typed by finish_chain
            return f"s{len(self.scalars) - 1}"
        if e.op == "reduce":
            if id(e) in self.local:
                return f"_acc{self.local[id(e)]}"
            if not self.allow_reduce:
                raise ValueError(
                    "reduction is an interior node here; plan it through "
                    "plan_many")
            if e.axis is None:
                for j, s in enumerate(self.scalars):
                    if s is e:
                        return f"s{j}"
                self.scalars.append(e)
                self.scalar_dtypes.append(_dtype_of(e))
                return f"s{len(self.scalars) - 1}"
            for j, nd in enumerate(self.bvecs):
                if nd is e:
                    return f"r{j}"
            self.bvecs.append(e)
            self.bvec_dtypes.append(_dtype_of(e))
            self.bvec_kinds.append("col" if e.axis == 0 else "row")
            return f"r{len(self.bvecs) - 1}"
        if e.op in ("+", "-", "*", "/"):
            a = self.emit(e.children[0])
            b = self.emit(e.children[1])
            return f"({a} {e.op} {b})"
        if e.op == "**":
            a = self.emit(e.children[0])
            b = self.emit(e.children[1])
            return f"powf({a}, {b})"
        if e.op == "neg":
            return f"(-{self.emit(e.children[0])})"
        if e.op in _UNARY_FUNCS:
            return f"{_UNARY_FUNCS[e.op]}({self.emit(e.children[0])})"
        raise ValueError(f"unknown expr op {e.op!r}")

    def finish_chain(self, owner_dtype) -> None:
        """Type the scalar slots appended by the chain just emitted: a
        computed reduction keeps its own plan dtype; an embedded number
        promotes with the dtype of the chain that *owns* it."""
        for j in range(len(self.scalar_dtypes)):
            if self.scalar_dtypes[j] is None:
                self.scalar_dtypes[j] = _result_type(
                    [self.scalars[j], owner_dtype])

    def leaf_kinds(self, b: int, n: int) -> list:
        return [_leaf_kind(a, b, n) for a in self.leaves]


@dataclass
class FusionPlan:
    """Executable product of the fusion planner: ONE generated kernel.

    ``snippet`` is the serialized DAG in the C dialect (``prelude`` holds
    hoisted common subexpressions); ``leaves``/``scalars``/``bvecs`` are
    the positional arguments it references as ``v<j>``/``s<j>``/``r<j>``.
    ``reduce_expr is None`` plans a fused elementwise kernel; otherwise
    the snippet(s) become the map expression(s) of one `ReductionKernel`
    — flat when ``axis is None``, segmented when ``axis`` is -1 or 0.
    Lists plan ONE multi-output kernel (`plan_many`).  Kernels are
    content-cached on ``key`` (DAG structure × dtypes × arg kinds, never
    scalar values), so isomorphic plans share one kernel.
    """

    snippet: str | list
    leaves: list = field(default_factory=list)
    scalars: list = field(default_factory=list)
    out_dtype: Any = None
    reduce_expr: str | list | None = None
    neutral: str | list | None = None
    key: str = ""
    scalar_dtypes: list = field(default_factory=list)
    nodes: list = field(default_factory=list)   # reduce nodes this plan computes
    bvecs: list = field(default_factory=list)   # segmented-reduce _Expr args
    bvec_dtypes: list = field(default_factory=list)
    bvec_kinds: list = field(default_factory=list)  # "row" | "col" per bvec
    leaf_kinds: list = field(default_factory=list)
    prelude: list = field(default_factory=list)
    axis: int | None = None                     # None: flat | -1: rows | 0: cols
    geometry: tuple = ()                        # (n,) flat | (B, N) rows
    out_shapes: list = field(default_factory=list)  # epilogue template shapes
    backend: Any = None                         # None: resolve per leaf device

    @property
    def kernel_launches(self) -> int:
        return 1  # any plan is exactly one launch

    @property
    def _multi(self) -> bool:
        return isinstance(self.snippet, (list, tuple))

    def _out_dtypes(self) -> list:
        return list(self.out_dtype) if isinstance(self.out_dtype, (list, tuple)) \
            else [self.out_dtype]

    def _arg_list(self) -> list:
        dts = self.scalar_dtypes or [self._out_dtypes()[0]] * len(self.scalars)
        args = [ScalarArg(dt, f"s{j}") for j, dt in enumerate(dts)]
        bkinds = self.bvec_kinds or ["row"] * len(self.bvec_dtypes)
        args += [BroadcastArg(dt, f"r{j}", k)
                 for j, (dt, k) in enumerate(zip(self.bvec_dtypes, bkinds))]
        kinds = self.leaf_kinds or ["full"] * len(self.leaves)
        for j, (a, k) in enumerate(zip(self.leaves, kinds)):
            if k == "full":
                args.append(VectorArg(a.dtype, f"v{j}"))
            elif k == "scalar":
                args.append(ScalarArg(a.dtype, f"v{j}"))
            else:
                args.append(BroadcastArg(a.dtype, f"v{j}", k))
        return args

    def kernel(self):
        """Build-or-fetch the one generated kernel realizing this plan,
        pinned to the resolved backend (the plan's, else the process
        selection, else the leaves' device)."""
        bname = _backends.get_backend(self.backend, self.leaves[0]).name
        ckey = (bname, self.key)
        if self.reduce_expr is None:
            kern = _kernel_cache.get(ckey)
            if kern is None:
                snips = [self.snippet] if not self._multi else list(self.snippet)
                odts = self._out_dtypes()
                out_names = ["out"] if not self._multi else \
                    [f"out{j}" for j in range(len(snips))]
                args = (self._arg_list()
                        + [VectorArg(d, nm) for nm, d in zip(out_names, odts)])
                stmts = list(self.prelude) + [
                    f"{nm}[i] = {sn}" for nm, sn in zip(out_names, snips)]
                kern = ElementwiseKernel(
                    args, "; ".join(stmts), name=f"fused_{self.key[:8]}",
                    layout="rows" if self.axis is not None else "flat",
                    backend=bname)
                _kernel_cache.put(ckey, kern)
            return kern
        kern = _reduce_cache.get(ckey)
        if kern is None:
            kern = ReductionKernel(self.out_dtype, self.neutral, self.reduce_expr,
                                   self.snippet, self._arg_list(),
                                   name=f"fusedred_{self.key[:8]}",
                                   axis=self.axis, prelude=self.prelude,
                                   backend=bname)
            _reduce_cache.put(ckey, kern)
        return kern

    def resolve_scalars(self, values: dict | None = None) -> list:
        svals = []
        for s in self.scalars:
            if isinstance(s, _Expr):
                if values is None or id(s) not in values:
                    raise ValueError("plan references a reduction whose value "
                                     "is not computed yet (launch the schedule)")
                svals.append(values[id(s)])
            else:
                svals.append(s)
        return svals

    def _resolve_bvecs(self, values: dict | None = None) -> list:
        out = []
        for nd in self.bvecs:
            if values is None or id(nd) not in values:
                raise ValueError("plan references a segmented reduction whose "
                                 "value is not computed yet (launch the "
                                 "schedule)")
            out.append(values[id(nd)])
        return out

    def _call_args(self, values: dict | None = None) -> list:
        kinds = self.leaf_kinds or ["full"] * len(self.leaves)
        leaf_args = [a.reshape(()) if k == "scalar" else a
                     for a, k in zip(self.leaves, kinds)]
        call_args = (self.resolve_scalars(values) + self._resolve_bvecs(values)
                     + leaf_args)
        if self.reduce_expr is None:
            # output templates: never alias an input (nothing reads them,
            # so they are not filled)
            dev = self.leaves[0].device
            shapes = self.out_shapes or [self.geometry] * len(self._out_dtypes())
            call_args.extend(torch.empty(s, dtype=d, device=dev)
                             for s, d in zip(shapes, self._out_dtypes()))
        return call_args

    def launch(self, values: dict | None = None):
        return self.kernel()(*self._call_args(values))

    def autotune(self, values: dict | None = None, **tune_kwargs):
        raise NotImplementedError(_TUNE)


@dataclass
class FusionSchedule:
    """Minimal launch schedule for DAGs with interior reductions.

    ``steps`` are dependency-ordered reduction waves (each ONE generated
    multi-accumulator `ReductionKernel` launch — flat or segmented);
    ``epilogues`` hold ONE fused elementwise kernel per output geometry;
    scalar-only roots (the ``/n`` of a terminal ``.mean()``) fold outside
    any generated kernel.
    """

    steps: list = field(default_factory=list)       # FusionPlans (reductions)
    epilogues: list = field(default_factory=list)   # FusionPlans (elementwise)
    outputs: list = field(default_factory=list)     # (kind, payload) per root

    @property
    def epilogue(self):
        """Single-epilogue accessor (most schedules have <= 1)."""
        return self.epilogues[0] if self.epilogues else None

    @property
    def kernel_launches(self) -> int:
        return len(self.steps) + len(self.epilogues)

    def _run_steps(self) -> dict:
        values: dict = {}
        for step in self.steps:
            outs = step.launch(values)
            if not isinstance(outs, tuple):
                outs = (outs,)
            for node, v in zip(step.nodes, outs):
                values[id(node)] = v
        return values

    def autotune(self, **tune_kwargs) -> list:
        raise NotImplementedError(_TUNE)

    def launch(self) -> list:
        values = self._run_steps()
        epi_outs: list = []
        for epi in self.epilogues:
            outs = epi.launch(values)
            epi_outs.append(outs if isinstance(outs, tuple) else (outs,))
        results = []
        for kind, payload in self.outputs:
            if kind == "value":
                results.append(payload)
            elif kind == "reduce":
                results.append(values[id(payload)])
            elif kind == "epi":
                gi, idx = payload
                results.append(epi_outs[gi][idx])
            else:  # scalar/row expression over reduced values
                snippet, scalars, bvecs = payload
                env = {"_c": snippets.TORCH_NAMESPACE, "torch": torch}
                for j, s in enumerate(scalars):
                    env[f"s{j}"] = values[id(s)] if isinstance(s, _Expr) else s
                for j, nd in enumerate(bvecs):
                    env[f"r{j}"] = values[id(nd)]
                results.append(torch.as_tensor(
                    eval(snippets.translate_expression(snippet), env)))  # noqa: S307
        return results


def plan(expr: _Expr, reduce_expr: str | None = None,
         neutral: str | None = None, backend=None) -> FusionPlan:
    """Fusion planner (v1 surface): serialize a reduce-free expression DAG
    into one kernel plan.  With ``reduce_expr`` the elementwise chain
    *becomes* the generated reduction's ``map_expr`` — map+reduce in one
    launch.  Reduce-free chains over mixed-size leaves plan the 2-D row
    layout; equal-size leaves keep the flat layout."""
    ser = _Serializer(allow_reduce=False)
    ser.count(expr)
    snippet = ser.emit(expr)
    if not ser.leaves:
        raise ValueError("expression has no array leaves")
    out_dtype = _dtype_of(expr)
    ser.finish_chain(out_dtype)
    bs = _bshape(expr)
    axis = None
    if reduce_expr is None and len(bs) >= 2:
        b, n = _row_geometry(bs)
        kinds = ser.leaf_kinds(b, n)
        if any(k in ("row", "col") for k in kinds):
            axis = -1
            geometry = (b, n)
    if axis is None:
        n = 1
        for d in bs:
            n *= int(d)
        n = max(1, n)
        geometry = (n,)
        kinds = ser.leaf_kinds(1, n)
    key = stable_hash((snippet, ser.prelude,
                       [str(a.dtype) for a in ser.leaves], kinds,
                       len(ser.scalars), reduce_expr or "", neutral or "",
                       str(out_dtype), repr(axis)))
    return FusionPlan(snippet=snippet, leaves=list(ser.leaves),
                      scalars=list(ser.scalars), out_dtype=out_dtype,
                      reduce_expr=reduce_expr, neutral=neutral, key=key,
                      scalar_dtypes=list(ser.scalar_dtypes), leaf_kinds=kinds,
                      prelude=list(ser.prelude), axis=axis, geometry=geometry,
                      out_shapes=[tuple(bs)] if reduce_expr is None else [],
                      backend=backend)


def _plan_reduce_wave(ready: list, axis: int | None = None,
                      backend=None) -> FusionPlan:
    """ONE multi-accumulator ReductionKernel plan for a wave of reduce
    nodes (sibling reductions ride a single pass over the data).
    Segmented waves may contain nodes depending on *earlier nodes of the
    same wave* — those resolve in-kernel as ``_acc<k>``."""
    ser = _Serializer(allow_reduce=True,
                      local_nodes=tuple(ready) if axis is not None else ())
    for node in ready:
        ser.count(node.children[0])
    snips, neutrals, rexprs, odts = [], [], [], []
    for node in ready:
        snip = ser.emit(node.children[0])
        dt = _dtype_of(node.children[0])
        ser.finish_chain(dt)
        snips.append(snip)
        odts.append(dt)
        neutrals.append(_neutral_for(node.value, dt))
        rexprs.append(_REDUCE_EXPRS[node.value])
    if axis is None and ser.bvecs:
        raise NotImplementedError(
            "a row-wise reduction feeding a full reduction is not "
            "fusable; evaluate the row reduction first")
    if not ser.leaves:
        raise ValueError("reduction has no array leaves")
    bshapes = [_bshape(node.children[0]) for node in ready]
    if axis is None:
        n = 1
        for d in np.broadcast_shapes(*bshapes):
            n *= int(d)
        geometry = (max(1, n),)
        kinds = ser.leaf_kinds(1, geometry[0])
    else:
        geometry = _row_geometry(tuple(np.broadcast_shapes(*bshapes)))
        kinds = ser.leaf_kinds(*geometry)
    key = stable_hash((snips, ser.prelude, [str(a.dtype) for a in ser.leaves],
                       kinds, [str(d) for d in ser.scalar_dtypes],
                       [str(d) for d in ser.bvec_dtypes], ser.bvec_kinds,
                       rexprs, neutrals,
                       [str(d) for d in odts], repr(axis)))
    return FusionPlan(snippet=snips, leaves=list(ser.leaves),
                      scalars=list(ser.scalars), out_dtype=odts,
                      reduce_expr=rexprs, neutral=neutrals, key=key,
                      scalar_dtypes=list(ser.scalar_dtypes), nodes=list(ready),
                      bvecs=list(ser.bvecs), bvec_dtypes=list(ser.bvec_dtypes),
                      bvec_kinds=list(ser.bvec_kinds),
                      leaf_kinds=kinds, prelude=list(ser.prelude), axis=axis,
                      geometry=geometry, backend=backend)


def _schedule_waves(reduces: list, backend=None) -> list:
    """Partition reduce nodes into dependency waves: flat reductions whose
    interior reductions are computed go together; segmented reductions
    group per (geometry, axis), and a pending one whose remaining
    dependencies all sit inside a forming wave of the same geometry joins
    that wave (the dependency resolves in-kernel)."""
    steps: list = []
    done: set = set()
    pending = list(reduces)
    while pending:
        ready = [r for r in pending
                 if _interior_reduce_ids(r.children[0]) <= done]
        if not ready:  # cycle-impossible for DAGs built via operators
            raise ValueError("unschedulable reduction dependencies")
        placed: list = []
        flat_ready = [r for r in ready if r.axis is None]
        if flat_ready:
            steps.append(_plan_reduce_wave(flat_ready, backend=backend))
            placed += flat_ready
        row_ready = [r for r in ready if r.axis is not None]
        groups: dict = {}   # (geometry, axis) -> nodes: axis=0 and axis=-1
        for r in row_ready:  # waves never mix (different kernel domains)
            g = (_row_geometry(_bshape(r.children[0])), r.axis)
            groups.setdefault(g, []).append(r)
        placed_ids = {id(p) for p in placed}
        for (g, ax), nodes in groups.items():
            wave_ids = {id(r) for r in nodes}
            changed = True
            while changed:  # pull same-geometry dependents into the wave
                changed = False
                for r in pending:
                    if (id(r) in wave_ids or id(r) in placed_ids
                            or id(r) in done or r.axis != ax):
                        continue
                    if _row_geometry(_bshape(r.children[0])) != g:
                        continue
                    deps = _interior_reduce_ids(r.children[0])
                    if deps <= (done | wave_ids):
                        nodes.append(r)
                        wave_ids.add(id(r))
                        changed = True
            steps.append(_plan_reduce_wave(nodes, axis=ax, backend=backend))
            placed += nodes
            placed_ids |= wave_ids
        done |= {id(r) for r in placed}
        pending = [r for r in pending if id(r) not in done]
    return steps


def plan_many(exprs: list, backend=None) -> FusionSchedule:
    """Fusion planner v2/v3: schedule one or more expression DAGs — with
    scalar *and* segmented reductions as interior nodes — into a minimal
    launch sequence (module docstring); ``launch()`` yields one result
    per input expression."""
    roots = [e._expr if isinstance(e, RTCGArray) else e for e in exprs]

    # -- reduce nodes across all roots, post-order, deduped by identity
    reduces: list[_Expr] = []
    seen: set = set()

    def visit(e: _Expr) -> None:
        if id(e) in seen:
            return
        seen.add(id(e))
        for c in e.children:
            visit(c)
        if e.op == "reduce":
            reduces.append(e)

    for r in roots:
        visit(r)

    steps = _schedule_waves(reduces, backend=backend)

    # -- roots: computed reductions / fused epilogues / folded scalars
    outputs: list = []
    groups: list = []        # (geometry key, [roots])
    group_index: dict = {}
    for root in roots:
        if root.op == "leaf":
            outputs.append(("value", root.value))
        elif root.op == "reduce":
            outputs.append(("reduce", root))
        elif _vector_outside_reduce(root):
            gkey = tuple(int(d) for d in _bshape(root))
            gi = group_index.get(gkey)
            if gi is None:
                gi = len(groups)
                group_index[gkey] = gi
                groups.append((gkey, []))
            outputs.append(("epi", (gi, len(groups[gi][1]))))
            groups[gi][1].append(root)
        else:
            ser = _Serializer(allow_reduce=True, cse=False)
            snip = ser.emit(root)
            outputs.append(("host", (snip, list(ser.scalars), list(ser.bvecs))))

    epilogues: list = []
    for gkey, groots in groups:
        ser = _Serializer(allow_reduce=True)
        for r in groots:
            ser.count(r)
        snips, odts, oshapes = [], [], []
        for r in groots:
            snips.append(ser.emit(r))
            dt = _dtype_of(r)
            ser.finish_chain(dt)
            odts.append(dt)
            oshapes.append(gkey)
        if len(gkey) >= 2:
            b, n = _row_geometry(gkey)
            kinds = ser.leaf_kinds(b, n)
            # 2-D roots need the row layout only when something actually
            # broadcasts per row/col; all-full leaves keep the flat layout
            rows = bool(ser.bvecs) or any(k in ("row", "col") for k in kinds)
            axis = -1 if rows else None
            geometry = (b, n) if rows else (b * n,)
        else:
            n = int(gkey[0]) if gkey else 1
            axis, geometry = None, (max(1, n),)
            if ser.bvecs:
                raise NotImplementedError(
                    "a row-reduced value cannot re-enter a 1-D epilogue")
            kinds = ser.leaf_kinds(1, geometry[0])
        key = stable_hash((snips, ser.prelude,
                           [str(a.dtype) for a in ser.leaves], kinds,
                           [str(d) for d in ser.scalar_dtypes],
                           [str(d) for d in ser.bvec_dtypes], ser.bvec_kinds,
                           "", "",
                           [str(d) for d in odts], repr(axis)))
        epilogues.append(FusionPlan(
            snippet=snips, leaves=list(ser.leaves), scalars=list(ser.scalars),
            out_dtype=odts, reduce_expr=None, neutral=None, key=key,
            scalar_dtypes=list(ser.scalar_dtypes), bvecs=list(ser.bvecs),
            bvec_dtypes=list(ser.bvec_dtypes), bvec_kinds=list(ser.bvec_kinds),
            leaf_kinds=kinds,
            prelude=list(ser.prelude), axis=axis, geometry=geometry,
            out_shapes=oshapes, backend=backend))
    return FusionSchedule(steps=steps, epilogues=epilogues, outputs=outputs)


def autotune(*exprs, backend=None, **tune_kwargs) -> list:
    raise NotImplementedError(_TUNE)


def _tensor(value, device=None) -> torch.Tensor:
    """A leaf tensor: a tensor stays on its device unless ``device`` is
    given; anything else goes to ``device``, by default the card (which
    raises when there is none).  Dtypes follow the JAX x64-off rule."""
    if isinstance(value, torch.Tensor) and device is None:
        t = value
    else:
        t = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value, device=resolve_device(device))
    dt = _canonical(t.dtype)
    return t if t.dtype == dt else t.to(dt)


def _as_expr(x, device=None) -> _Expr:
    if isinstance(x, RTCGArray):
        return x._expr
    if isinstance(x, (bool, np.bool_, int, np.integer)):
        return _Expr("scalar", value=int(x))
    if isinstance(x, (float, np.floating)):
        return _Expr("scalar", value=float(x))
    if isinstance(x, (np.ndarray, torch.Tensor)):
        if x.ndim == 0:  # 0-d arrays are scalars, not leaves
            return _Expr("scalar", value=x.item())
        # host data joins the array's device; a tensor keeps its own
        return _Expr("leaf", value=_tensor(
            x, None if isinstance(x, torch.Tensor) else device))
    raise TypeError(f"cannot mix RTCGArray with {type(x).__name__}")


class RTCGArray:
    """Lazy, device-resident array evaluated through generated fused
    kernels.  ``RTCGArray(value, device=None)``: a tensor keeps its
    device; host data goes to ``device``, by default the card."""

    __array_priority__ = 200.0

    def __init__(self, value=None, _expr: _Expr | None = None, device=None):
        if _expr is not None:
            self._expr = _expr
        else:
            self._expr = _Expr("leaf", value=_tensor(value, device))

    # -- construction ---------------------------------------------------
    @staticmethod
    def to_gpu(host_array, device=None) -> "RTCGArray":
        return RTCGArray(host_array, device=device)

    @property
    def shape(self):
        return _shape_of(self._expr)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return _dtype_of(self._expr)

    @property
    def device(self) -> torch.device:
        return _first_leaf(self._expr).device

    # -- lazy ops ---------------------------------------------------------
    def _bin(self, other, op, rev=False):
        a, b = self._expr, _as_expr(other, self.device)
        if rev:
            a, b = b, a
        return RTCGArray(_expr=_Expr(op, (a, b)))

    __add__ = lambda self, o: self._bin(o, "+")
    __radd__ = lambda self, o: self._bin(o, "+", rev=True)
    __sub__ = lambda self, o: self._bin(o, "-")
    __rsub__ = lambda self, o: self._bin(o, "-", rev=True)
    __mul__ = lambda self, o: self._bin(o, "*")
    __rmul__ = lambda self, o: self._bin(o, "*", rev=True)
    __truediv__ = lambda self, o: self._bin(o, "/")
    __rtruediv__ = lambda self, o: self._bin(o, "/", rev=True)
    __pow__ = lambda self, o: self._bin(o, "**")
    __rpow__ = lambda self, o: self._bin(o, "**", rev=True)
    __neg__ = lambda self: RTCGArray(_expr=_Expr("neg", (self._expr,)))

    def _unary(self, name):
        return RTCGArray(_expr=_Expr(name, (self._expr,)))

    exp = lambda self: self._unary("exp")
    log = lambda self: self._unary("log")
    sqrt = lambda self: self._unary("sqrt")
    tanh = lambda self: self._unary("tanh")
    sigmoid = lambda self: self._unary("sigmoid")
    abs = lambda self: self._unary("abs")
    __abs__ = abs

    # -- evaluation -------------------------------------------------------
    def _evaluate_expr(self, backend=None) -> torch.Tensor:
        expr = self._expr
        if expr.op == "leaf":
            return expr.value
        if isinstance(backend, str) and backend.lower() == "auto":
            raise NotImplementedError(_AUTO)
        # one backend for the whole schedule: pinned, else the process
        # selection, else the leaves' device
        be = _backends.get_backend(backend, _first_leaf(expr)).name
        if _has_reduce(expr):
            return plan_many([expr], backend=be).launch()[0]
        return plan(expr, backend=be).launch()

    def evaluate(self, backend=None, family=None) -> "RTCGArray":
        """Force the DAG through the planner; ``backend`` pins the
        execution backend of every generated kernel in the schedule
        (default: ``REPRO_TORCH_BACKEND``, else ``cuda`` for tensors on
        the card and ``eager`` for CPU tensors).  A build or launch
        failure raises: the JAX package's degradation ladder (whose
        breaker cells ``family`` names) is not ported yet."""
        if family is not None:
            raise NotImplementedError(_LADDER)
        if self._expr.op == "leaf":
            return self
        return RTCGArray(self._evaluate_expr(backend))

    def get(self) -> np.ndarray:
        """The values as a host numpy array (PyCUDA's ``get``)."""
        return self.evaluate()._expr.value.cpu().numpy()

    @property
    def value(self) -> torch.Tensor:
        return self.evaluate()._expr.value

    def __float__(self) -> float:
        return float(self.value)

    def __int__(self) -> int:
        return int(self.value)

    # -- fused reductions ---------------------------------------------------
    def _norm_axis(self, axis) -> int | None:
        nd = len(self.shape)
        if axis is None:
            return None
        if axis in (-1, nd - 1) and nd >= 2:
            return -1
        if axis in (0, -2) and nd == 2:
            return 0  # column-wise over (B, N) — transpose_layout domain
        if axis in (-1, 0) and nd <= 1:
            return None  # last axis of a vector IS the full reduction
        raise NotImplementedError(
            f"axis={axis} over a {nd}-d operand; only axis=None (full), "
            f"axis=-1 (row-wise) and axis=0 (column-wise, 2-D) reductions "
            f"are fusable")

    def _reduce(self, kind: str, fuse: bool = True,
                axis: int | None = None) -> "RTCGArray":
        axis = self._norm_axis(axis)
        if not fuse and self._expr.op != "leaf":
            # unfused baseline: materialize the map (kernel 1), then
            # reduce the temporary (kernel 2)
            return self.evaluate()._reduce(kind, axis=axis)
        return RTCGArray(_expr=_Expr("reduce", (self._expr,), value=kind,
                                     axis=axis))

    def sum(self, axis: int | None = None, fuse: bool = True) -> "RTCGArray":
        return self._reduce("sum", fuse=fuse, axis=axis)

    def mean(self, axis: int | None = None, fuse: bool = True) -> "RTCGArray":
        ax = self._norm_axis(axis)
        if ax == 0:
            n = int(self.shape[0])
        elif ax is not None:
            n = int(self.shape[-1])
        else:
            n = int(np.prod(self.shape))
        return self._reduce("sum", fuse=fuse, axis=axis) / float(n)

    def max(self, axis: int | None = None, fuse: bool = True) -> "RTCGArray":
        return self._reduce("max", fuse=fuse, axis=axis)

    def min(self, axis: int | None = None, fuse: bool = True) -> "RTCGArray":
        return self._reduce("min", fuse=fuse, axis=axis)

    def dot(self, other: "RTCGArray", fuse: bool = True) -> "RTCGArray":
        return (self * other)._reduce("sum", fuse=fuse)

    def __repr__(self):
        tag = "lazy" if self._expr.op != "leaf" else "concrete"
        return f"RTCGArray({tag}, shape={self.shape}, dtype={self.dtype})"


def to_gpu(host_array, device=None) -> RTCGArray:
    """Host data (or a tensor) as an `RTCGArray`: on the card unless
    ``device`` says otherwise or the data is already a tensor."""
    return RTCGArray.to_gpu(host_array, device=device)


def empty_like(a: RTCGArray) -> RTCGArray:
    return RTCGArray(torch.zeros(a.shape, dtype=a.dtype, device=a.device))


def exp(a: RTCGArray) -> RTCGArray:
    return a._unary("exp")


def log(a: RTCGArray) -> RTCGArray:
    return a._unary("log")


def sqrt(a: RTCGArray) -> RTCGArray:
    return a._unary("sqrt")


def tanh(a: RTCGArray) -> RTCGArray:
    return a._unary("tanh")


def abs(a: RTCGArray) -> RTCGArray:  # noqa: A001 - mirrors numpy namespace
    return a._unary("abs")


def softmax(a: RTCGArray, stable: bool = False, axis: int = -1) -> RTCGArray:
    """Softmax through the fusion planner.

    1-D operands keep the flat schedule: unstable is ONE reduce + ONE
    fused epilogue (2 launches); ``stable=True`` subtracts the max first
    (3 launches — the flat reduction cannot see the max in the same
    pass).  2-D ``(B, N)`` operands schedule *segmented*, and
    ``stable=True`` stays at 2 launches (max and shifted-exp sum share
    one wave).  ``axis=-1`` (default) normalizes rows, ``axis=0``
    columns.
    """
    if len(a.shape) < 2:
        ax = None
    else:
        ax = 0 if axis in (0, -2) else -1
    if stable:
        e = (a - a.max(axis=ax)).exp()
    else:
        e = a.exp()
    return e / e.sum(axis=ax)
