"""CudaBackend — the kernel IR rendered to CUDA C and compiled at run time.

The counterpart of the JAX package's ``PallasBackend``, and the paper's
own path: PyCUDA took CUDA C, compiled it with ``nvcc`` at run time and
cached the binary by content.  The snippets this pipeline accepts
(``"expf(x[i] - _acc0)"``, ``"fmaxf(a, b)"``) are that C, so here they
go back to being C: `render_ir` fills the templates under
``repro_torch/csrc`` with the snippets, `CudaSourceModule` compiles the
result for ``sm_90a`` into a shared library with plain ``extern "C"``
entry points, and the driver calls them through ``ctypes`` on PyTorch's
current stream.

Five kernels, one per TPU kernel of the RTCG library (``pallas.py``):

  * the row reduction (`row_reduce.cu.j2`; replaces
    ``build_reduction_rows``, the ``pallas_call`` at line 391): one block
    per row, one sweep per accumulator level, ``_acc<k>`` broadcast
    through shared memory; the axis=0 form binds the full operands with
    their strides swapped;
  * the rows elementwise pass (`eltwise_rows.cu.j2`; replaces
    ``build_elementwise_rows``, line 307): a 2-D grid, or — when the
    snippet has ``cumsumf`` — one block per row with a block-wide
    inclusive scan carried across column tiles;
  * the flat elementwise pass (`eltwise_flat.cu.j2`; replaces
    ``build_elementwise``, line 268): a grid-stride loop over the global
    index ``i``;
  * the flat reduction (`reduce_flat.cu.j2`; replaces
    ``build_reduction``, line 349): per-block partials folded by the
    last block to finish, one launch;
  * the prefix scan (`scan.cu.j2`; replaces ``build_scan``'s two
    ``pallas_call``s, lines 441 and 446): two kernels, the carries
    between them in plain torch as in the JAX package.

No source depends on the bucket: sizes, row lengths and strides are
run-time arguments, so one build serves every bucket (the dispatch keys
keep the bucket anyway, so driver-build and launch counts match the JAX
package's).  The drivers allocate outputs and scratch with
``torch.empty``, raise on a non-CUDA operand and on a non-zero CUDA
error code, and count one launch per successful kernel launch with
`dispatch.record_kernel_launch`.  Nothing here falls back to another
backend.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from repro_torch.core import dispatch, snippets
from repro_torch.core.backends.base import (Backend, bind_operand,
                                            bind_row_lens, check_arity,
                                            operand_device)
from repro_torch.core.platform import bind_flat_operand, canonical_dtype
from repro_torch.core.rtcg import CudaSourceModule, check_launch
from repro_torch.core.templates import KernelTemplate

_ROW_REDUCE_TMPL = KernelTemplate.from_file("row_reduce", "row_reduce.cu.j2")
_ELTWISE_TMPL = KernelTemplate.from_file("eltwise_rows", "eltwise_rows.cu.j2")
_FLAT_ELTWISE_TMPL = KernelTemplate.from_file("eltwise_flat",
                                              "eltwise_flat.cu.j2")
_FLAT_REDUCE_TMPL = KernelTemplate.from_file("reduce_flat",
                                             "reduce_flat.cu.j2")
_SCAN_TMPL = KernelTemplate.from_file("scan", "scan.cu.j2")

#: threads per block: wide blocks keep a row's loads in flight when the
#: batch has few rows (the sampler flush has one row per live request)
THREADS = {"row_reduction": 1024, "rows_elementwise": 256,
           "rows_elementwise_scan": 1024, "flat_elementwise": 256,
           "flat_reduction": 512, "scan": 1024}

#: elements per thread of a scan tile (a tile is 1024 x 4 = 4096
#: elements, the JAX package's default block_n)
SCAN_ITEMS = 4

#: grid of the grid-stride kernels, in waves of fully resident blocks
#: (2048 threads per SM): the flat reduction runs one wave, so its
#: partials fit one block's fold; the flat elementwise pass four
WAVES = {"flat_elementwise": 4, "flat_reduction": 1}

#: dtype -> (CUDA C type, ctypes scalar type) for the types the port
#: binds; others raise at render time
_CTYPES = {
    "float32": ("float", ctypes.c_float),
    "int32": ("int", ctypes.c_int32),
    "uint32": ("unsigned int", ctypes.c_uint32),
    "bool": ("bool", ctypes.c_bool),
}
_PYTYPES = {"float32": float, "int32": int, "uint32": int, "bool": bool}


def _ctype(dt: str) -> str:
    try:
        return _CTYPES[dt][0]
    except KeyError:
        raise NotImplementedError(
            f"dtype {dt!r} has no CUDA C binding "
            f"(supported: {sorted(_CTYPES)})") from None


def _acc_type(reducer: str, dt: str) -> str:
    """Arithmetic type of a fold: int32 sums and products run in
    ``unsigned int`` (they wrap as the JAX package's int32 arithmetic
    does, where signed overflow in C++ is undefined); bool folds too."""
    ct = _ctype(dt)
    if dt == "bool" or (dt == "int32" and reducer in ("sum", "prod")):
        return "unsigned int"
    return ct


def _combine(reducer: str, acc: str) -> str:
    """C combine of ``a`` and ``b`` for a fold: chosen from the reducer
    and the arithmetic type, so an integer max never passes through
    ``fmaxf``'s float conversion."""
    if reducer == "sum":
        return "a + b"
    if reducer == "prod":
        return "a * b"
    if acc == "float":
        return f"f{reducer}f(a, b)"
    return f"{reducer}(a, b)"


def _fold(o: dict) -> dict:
    """Template fields of one reduction accumulator."""
    ct = _ctype(o["dtype"])
    acc = _acc_type(o["reducer"], o["dtype"])
    return dict(ctype=ct, acc=acc, combine=_combine(o["reducer"], acc),
                to_acc=f"({ct})" if acc == ct else f"({acc})({ct})",
                map_expr=snippets.c_expression(o["map_expr"]),
                neutral=o["neutral"])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _grid(n: int, kernel: str, device) -> int:
    """Blocks of a grid-stride kernel over ``n`` elements: one per
    ``THREADS`` elements, capped at `WAVES` waves of resident blocks."""
    threads = THREADS[kernel]
    cap = _sm_count(device.index if device.index is not None
                    else torch.cuda.current_device()) \
        * (2048 // threads) * WAVES[kernel]
    return max(1, min(-(-n // threads), cap))


def _signature(kir, strides: int):
    """Kernel parameter declarations, call-through names and ctypes
    argtypes of the IR's positional operands (in order).  A full operand
    passes its pointer and ``strides`` strides (0 flat; 1 rows: the row
    stride; 2: row and column strides, for the transposed layout)."""
    params, names, argtypes = [], [], []
    for name, dt, kind in kir.args:
        ct = _ctype(dt)
        if kind == "scalar":
            params.append(f"{ct} {name}")
            names.append(name)
            argtypes.append(_CTYPES[dt][1])
        elif kind == "full":
            sfx = ["_s", "_cs"][:strides]
            params += [f"const {ct}* __restrict__ {name}_p"] + \
                [f"long long {name}{x}" for x in sfx]
            names += [f"{name}_p"] + [f"{name}{x}" for x in sfx]
            argtypes += [ctypes.c_void_p] + [ctypes.c_longlong] * strides
        else:  # row / col broadcast vectors
            params.append(f"const {ct}* __restrict__ {name}_p")
            names.append(f"{name}_p")
            argtypes.append(ctypes.c_void_p)
    return params, names, argtypes


def _strides(kir) -> int:
    """Strides a row reduction's full operand passes: the row stride, and
    for the transposed (axis=0) layout the column stride too."""
    return 2 if kir.transposed else 1


def _loads(kir, read: set, guard: bool, col_stride: bool = False):
    """Per-row and per-column register loads: every operand the snippet
    reads is loaded once, under its own name, so the C snippet's
    ``x[i]`` (already stripped to ``x``) reads the thread's element."""
    row_loads, col_loads = [], []
    for name, dt, kind in kir.args:
        ct = _ctype(dt)
        if kind == "full":
            row_loads.append(f"const {ct}* __restrict__ {name}_row = "
                             f"{name}_p + (long long)_r * {name}_s;")
            if name in read:
                load = (f"{name}_row[(long long)_c * {name}_cs]"
                        if col_stride else f"{name}_row[_c]")
                col_loads.append(f"const {ct} {name} = " + (
                    f"_in ? {load} : ({ct})0;" if guard else f"{load};"))
        elif kind == "row" and name in read:
            row_loads.append(f"const {ct} {name} = {name}_p[_r];")
        elif kind == "col" and name in read:
            load = f"{name}_p[_c]"
            col_loads.append(f"const {ct} {name} = " + (
                f"_in ? {load} : ({ct})0;" if guard else f"{load};"))
    return row_loads, col_loads


def _out_registers(loads: list, out_ctypes: dict, read: set) -> list:
    """Written vectors live in registers: a fresh zero, or — read-modify-
    write — its load with the ``const`` dropped."""
    for o, ct in out_ctypes.items():
        if o not in read:
            loads.append(f"{ct} {o} = ({ct})0;")
        else:
            loads = [ln.replace(f"const {ct} {o} =", f"{ct} {o} =")
                     for ln in loads]
    return loads


def _statement(stmt: str, declared: set, out_ctypes: dict) -> str:
    """One C snippet statement as a CUDA C line (``[i]`` stripped)."""
    decl, tgt, rhs = snippets.c_statement(stmt)
    if tgt is None:
        return f"{rhs};"
    if tgt in out_ctypes:
        return f"{tgt} = ({out_ctypes[tgt]})({rhs});"
    if tgt in declared:
        return f"{tgt} = ({rhs});"
    declared.add(tgt)
    return f"{decl or 'auto'} {tgt} = ({rhs});"


class CudaBackend(Backend):
    name = "cuda"
    block_sensitive = False  # sources take sizes and strides at run time

    def fingerprint(self) -> dict:
        return {"backend": self.name, "torch": torch.__version__,
                "cuda": torch.version.cuda or "none", "arch": "sm_90a"}

    # -- render (IR -> CUDA C) ---------------------------------------------
    def render_ir(self, kir) -> str:
        flat = kir.meta_get("layout") == "flat"
        if kir.kind == "elementwise":
            return (self._render_elementwise_flat(kir) if flat
                    else self._render_elementwise(kir))
        if kir.kind == "reduction":
            return (self._render_reduction_flat(kir) if flat
                    else self._render_reduction(kir))
        if kir.kind == "scan":
            return self._render_scan(kir)
        raise ValueError(f"unknown IR kind {kir.kind!r}")

    def _render_reduction(self, kir) -> str:
        params, names, _ = _signature(kir, strides=_strides(kir))
        read = set(kir.meta_get("loaded_vectors", ()))
        ragged = kir.meta_get("ragged", False)
        row_loads, col_loads = _loads(kir, read, guard=ragged,
                                      col_stride=kir.transposed)
        declared = {a[0] for a in kir.args}
        prelude = [_statement(s, declared, {}) for s in kir.lines("prelude")]
        return _ROW_REDUCE_TMPL.render(
            name=kir.name, threads=THREADS["row_reduction"],
            preamble=kir.meta_get("preamble", ""), ragged=ragged,
            params=params, arg_names=names, row_loads=row_loads,
            col_loads=col_loads, prelude_lines=prelude,
            outs=[_fold(o) for o in kir.outs])

    def _render_reduction_flat(self, kir) -> str:
        params, names, _ = _signature(kir, strides=0)
        read = set(kir.meta_get("loaded_vectors", ()))
        declared = {a[0] for a in kir.args}
        prelude = [_statement(s, declared, {}) for s in kir.lines("prelude")]
        outs = [_fold(o) for o in kir.outs]
        exprs = [o["map_expr"] for o in outs] + prelude
        return _FLAT_REDUCE_TMPL.render(
            name=kir.name, threads=THREADS["flat_reduction"],
            preamble=kir.meta_get("preamble", ""),
            params=params, arg_names=names, loads=self._flat_loads(kir, read),
            prelude_lines=prelude, outs=outs,
            needs_i=any(snippets.uses_index(e) for e in exprs))

    @staticmethod
    def _flat_loads(kir, read: set) -> list:
        return [f"const {_ctype(dt)} {name} = {name}_p[_i];"
                for name, dt, kind in kir.args
                if kind == "full" and name in read]

    def _render_elementwise_flat(self, kir) -> str:
        out_ctypes = {o: _ctype(d) for o, d in kir.outs}
        declared = {a[0] for a in kir.args}
        body = []
        for stmt in kir.lines("body"):
            if "cumsumf" in stmt:
                raise NotImplementedError(
                    "cumsumf is a row scan: use layout='rows'")
            body.append(_statement(stmt, declared, out_ctypes))
        read = set(kir.meta_get("loaded_vectors", ()))
        loads = _out_registers(self._flat_loads(kir, read), out_ctypes, read)
        params, names, _ = _signature(kir, strides=0)
        for o, ct in out_ctypes.items():
            params.append(f"{ct}* __restrict__ {o}_out")
            names.append(f"{o}_out")
        return _FLAT_ELTWISE_TMPL.render(
            name=kir.name, threads=THREADS["flat_elementwise"],
            preamble=kir.meta_get("preamble", ""),
            needs_i=kir.meta_get("needs_i", False),
            params=params, arg_names=names, loads=loads, body_lines=body,
            outs=[dict(name=o) for o in out_ctypes])

    def _render_elementwise(self, kir) -> str:
        out_ctypes = {o: _ctype(d) for o, d in kir.outs}
        declared = {a[0] for a in kir.args}
        body, scans = [], 0
        for stmt in kir.lines("body"):
            rhs, found = snippets.extract_cumsum(stmt, start=scans)
            for k, arg in found:
                body.append(f"const float _pre{k} = (float)"
                            f"({snippets.c_expression(arg)});")
                body.append(f"const float _scan{k} = block_inclusive_scan("
                            f"_pre{k}, _carry{k}, _wtot);")
            scans += len(found)
            body.append(_statement(rhs, declared, out_ctypes))
        read = set(kir.meta_get("loaded_vectors", ()))
        row_loads, col_loads = _loads(kir, read, guard=bool(scans))
        col_loads = _out_registers(col_loads, out_ctypes, read)
        params, names, _ = _signature(kir, strides=1)
        for o, ct in out_ctypes.items():
            params += [f"{ct}* __restrict__ {o}_out", f"long long {o}_os"]
            names += [f"{o}_out", f"{o}_os"]
        return _ELTWISE_TMPL.render(
            name=kir.name,
            threads=THREADS["rows_elementwise_scan" if scans
                            else "rows_elementwise"],
            preamble=kir.meta_get("preamble", ""),
            ragged=kir.meta_get("ragged", False), scans=scans,
            params=params, arg_names=names, row_loads=row_loads,
            col_loads=col_loads, body_lines=body,
            outs=[dict(name=o, ctype=ct) for o, ct in out_ctypes.items()])

    def _render_scan(self, kir) -> str:
        dt, cumop = kir.meta_get("dtype"), kir.meta_get("cumop")
        vtype = _acc_type(cumop, dt)
        return _SCAN_TMPL.render(
            name=kir.name, exclusive=kir.meta_get("exclusive"), cumop=cumop,
            ctype=_ctype(dt), vtype=vtype, combine=_combine(cumop, vtype),
            neutral=kir.meta_get("neutral"), threads=THREADS["scan"],
            items=SCAN_ITEMS)

    # -- drivers -----------------------------------------------------------
    def _launcher(self, kir, entry: str, argtypes) -> Callable:
        """One entry point of the kernel's library, compiled on the
        driver's first call (after its operands passed the device
        check)."""
        fn = None

        def launch(*cargs) -> int:
            nonlocal fn
            if fn is None:
                mod = CudaSourceModule.load(self.render_ir(kir), name=kir.name)
                fn = mod.get_function(entry, argtypes)
            return fn(*cargs)

        return launch

    @staticmethod
    def _device(kir, device) -> torch.device:
        if device.type != "cuda":
            raise ValueError(
                f"backend 'cuda' launches on CUDA tensors; kernel "
                f"{kir.name!r} got operands on {device} (use backend="
                f"'eager' for CPU tensors)")
        return device

    @staticmethod
    def _stream(device) -> int:
        return torch.cuda.current_stream(device).cuda_stream

    def _bind(self, kir, flat_args, bind_one, strides: int):
        """Operand launch arguments, in order: a scalar by value (a 0-d
        tensor costs one ``.item()``), a vector by pointer (a full one
        with ``strides`` strides), each bound by ``bind_one(kind, name,
        arg, dtype, device)``.  The bound tensors come back too: the
        driver keeps them referenced until the launch returns (later
        reuse of their memory is ordered on the same stream)."""
        device = self._device(kir, operand_device(kir, flat_args))
        check_arity(kir, flat_args)
        cargs, keep = [], []
        for (name, dt, kind), arg in zip(kir.args, flat_args):
            if kind == "scalar":
                v = arg.item() if isinstance(arg, torch.Tensor) else arg
                cargs.append(_PYTYPES[dt](v))
                continue
            t = bind_one(kind, name, arg, dt, device)
            keep.append(t)
            cargs.append(t.data_ptr())
            if kind == "full":
                cargs += [t.stride(d) for d in range(strides)]
        return device, cargs, keep

    def _bind_rows(self, kir, b, n, flat_args, row_lens, strides: int):
        """Launch arguments of a rows-form kernel: stream, sizes, the row
        lengths (ragged form), then the operands in domain order."""
        device, cargs, keep = self._bind(
            kir, flat_args,
            lambda kind, name, arg, dt, dev: bind_operand(
                kir, kind, name, arg, dt, b, n, dev), strides)
        lens = bind_row_lens(row_lens, b, n, device) \
            if kir.meta_get("ragged", False) else None
        keep.append(lens)
        return device, [self._stream(device), b, n,
                        None if lens is None else lens.data_ptr()] + cargs, keep

    def _bind_flat(self, kir, n, flat_args):
        """Operand launch arguments of a flat kernel (nothing padded)."""
        return self._bind(
            kir, flat_args,
            lambda kind, name, arg, dt, dev: bind_flat_operand(
                kind, name, arg, canonical_dtype(dt), n, dev), 0)

    @staticmethod
    def _check(err: int, kir) -> None:
        check_launch(err, kir.name)

    def build_reduction_rows(self, kir) -> Callable:
        dtypes = [canonical_dtype(o["dtype"]) for o in kir.outs]
        strides = _strides(kir)
        _, _, argtypes = _signature(kir, strides=strides)
        launch = self._launcher(
            kir, f"{kir.name}_launch",
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            + argtypes + [ctypes.c_void_p] * len(dtypes))
        multi = kir.meta_get("multi", False)

        def driver(b, n, flat_args, row_lens=None):
            device, cargs, keep = self._bind_rows(kir, b, n, flat_args,
                                                  row_lens, strides)
            outs = [torch.empty(b, dtype=dt, device=device) for dt in dtypes]
            self._check(launch(*cargs, *[o.data_ptr() for o in outs]), kir)
            dispatch.record_kernel_launch("row_reduction")
            del keep
            return tuple(outs) if multi else outs[0]

        return driver

    def build_elementwise_rows(self, kir) -> Callable:
        dtypes = [canonical_dtype(d) for _, d in kir.outs]
        _, _, argtypes = _signature(kir, strides=1)
        launch = self._launcher(
            kir, f"{kir.name}_launch",
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            + argtypes + [ctypes.c_void_p, ctypes.c_longlong] * len(dtypes))

        def driver(b, n, flat_args, row_lens=None):
            device, cargs, keep = self._bind_rows(kir, b, n, flat_args,
                                                  row_lens, 1)
            outs = [torch.empty((b, n), dtype=dt, device=device)
                    for dt in dtypes]
            for o in outs:
                cargs += [o.data_ptr(), o.stride(0)]
            self._check(launch(*cargs), kir)
            dispatch.record_kernel_launch("rows_elementwise")
            del keep
            return outs

        return driver

    def build_elementwise(self, kir) -> Callable:
        dtypes = [canonical_dtype(d) for _, d in kir.outs]
        _, _, argtypes = _signature(kir, strides=0)
        launch = self._launcher(
            kir, f"{kir.name}_launch",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + argtypes
            + [ctypes.c_void_p] * len(dtypes))

        def driver(n, flat_args):
            device, cargs, keep = self._bind_flat(kir, n, flat_args)
            outs = [torch.empty(n, dtype=dt, device=device) for dt in dtypes]
            if n > 0:
                self._check(launch(self._stream(device), n,
                                   _grid(n, "flat_elementwise", device),
                                   *cargs, *[o.data_ptr() for o in outs]), kir)
                dispatch.record_kernel_launch("flat_elementwise")
            del keep
            return outs

        return driver

    def build_reduction(self, kir) -> Callable:
        dtypes = [canonical_dtype(o["dtype"]) for o in kir.outs]
        _, _, argtypes = _signature(kir, strides=0)
        launch = self._launcher(
            kir, f"{kir.name}_launch",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p] + argtypes
            + [ctypes.c_void_p, ctypes.c_void_p] * len(dtypes))
        multi = kir.meta_get("multi", False)
        # (device, stream) -> the last-block ticket, kept at 0 between
        # launches: launches on one stream run in order, and two streams
        # never share a ticket, so concurrent grids never mix their counts
        tickets: dict = {}

        def driver(n, flat_args):
            device, cargs, keep = self._bind_flat(kir, n, flat_args)
            grid = _grid(n, "flat_reduction", device)
            stream = self._stream(device)
            ticket = tickets.get((device, stream))
            if ticket is None:
                ticket = tickets.setdefault(
                    (device, stream),
                    torch.zeros(1, dtype=torch.int32, device=device))
            # one 4-byte partial per block and accumulator
            part = torch.empty((len(dtypes), grid), dtype=torch.int32,
                               device=device)
            outs = [torch.empty((), dtype=dt, device=device) for dt in dtypes]
            ptrs = [p for j, o in enumerate(outs)
                    for p in (part[j].data_ptr(), o.data_ptr())]
            self._check(launch(stream, n, grid, ticket.data_ptr(), *cargs,
                               *ptrs), kir)
            dispatch.record_kernel_launch("flat_reduction")
            del keep
            return tuple(outs) if multi else outs[0]

        return driver

    def build_scan(self, kir) -> Callable:
        dt = canonical_dtype(kir.meta_get("dtype"))
        cumop = kir.meta_get("cumop")
        neutral = float(snippets.translate_expression(kir.meta_get("neutral")))
        args = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        pass1 = self._launcher(kir, f"{kir.name}_pass1_launch", args)
        pass2 = self._launcher(kir, f"{kir.name}_pass2_launch", args)
        tile = THREADS["scan"] * SCAN_ITEMS

        def driver(n, x):
            x = torch.as_tensor(x)
            device = self._device(kir, x.device)
            xf = x.reshape(-1).to(dt).contiguous()
            out = torch.empty(n, dtype=dt, device=device)
            if n == 0:
                return out
            grid = -(-n // tile)
            stream = self._stream(device)
            y = torch.empty(n, dtype=dt, device=device)
            tot = torch.empty(grid, dtype=dt, device=device)
            self._check(pass1(stream, n, grid, xf.data_ptr(), y.data_ptr(),
                              tot.data_ptr()), kir)
            dispatch.record_kernel_launch("scan_pass1")
            carry = _carries(tot, cumop, neutral)
            self._check(pass2(stream, n, grid, y.data_ptr(), carry.data_ptr(),
                              out.data_ptr()), kir)
            dispatch.record_kernel_launch("scan_pass2")
            return out

        return driver


def _carries(tot: torch.Tensor, cumop: str, neutral: float) -> torch.Tensor:
    """Each tile's carry: the exclusive scan of the tile totals with the
    neutral folded in, as plain torch between the passes (the JAX
    package runs it as jnp between its two pallas_calls,
    ``pallas.py:455-470``).  Every op scans the totals shifted right by
    one behind the neutral: ``*`` a shifted cumprod, never a division by
    a total (a zero total would make it 0/0)."""
    shifted = torch.cat([torch.full((1,), neutral, dtype=tot.dtype,
                                    device=tot.device), tot[:-1]])
    if cumop == "sum":
        return torch.cumsum(shifted, 0).to(tot.dtype)
    if cumop == "prod":
        return torch.cumprod(shifted, 0).to(tot.dtype)
    if cumop == "max":
        return torch.cummax(shifted, 0).values
    return torch.cummin(shifted, 0).values


__all__ = ["CudaBackend", "THREADS"]
