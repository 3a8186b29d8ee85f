"""CudaBackend — the kernel IR rendered to CUDA C and compiled at run time.

The counterpart of the JAX package's ``PallasBackend``, and the paper's
own path: PyCUDA took CUDA C, compiled it with ``nvcc`` at run time and
cached the binary by content.  The snippets this pipeline accepts
(``"expf(x[i] - _acc0)"``, ``"fmaxf(a, b)"``) are that C, so here they
go back to being C: `render_ir` fills the templates under
``repro_torch/csrc`` (`row_reduce.cu.j2`, `eltwise_rows.cu.j2`) with the
snippets, `CudaSourceModule` compiles the result for ``sm_90a`` into a
shared library with a plain ``extern "C"`` entry point, and the driver
calls it through ``ctypes`` on PyTorch's current stream.

Two kernels, the rows forms the serving path runs:

  * the row reduction (replaces ``pallas.py`` ``build_reduction_rows``,
    the ``pallas_call`` at line 391): one block per row, one sweep per
    accumulator level, ``_acc<k>`` broadcast through shared memory;
  * the rows elementwise pass (replaces ``build_elementwise_rows``, the
    ``pallas_call`` at line 307): a 2-D grid, or — when the snippet has
    ``cumsumf`` — one block per row with a block-wide inclusive scan
    carried across column tiles.

Neither source depends on the bucket: ``b``, ``n``, the row lengths and
the strides are run-time arguments, so one build serves every bucket
(the dispatch keys keep the bucket anyway, so driver-build and launch
counts match the JAX package's).  The driver allocates the outputs with
``torch.empty``, raises on a non-CUDA operand and on a non-zero CUDA
error code, and counts one launch per successful kernel launch with
`dispatch.record_kernel_launch`.  Nothing here falls back to another
backend.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch.core import dispatch, snippets
from repro_torch.core.backends.base import (Backend, bind_row_lens,
                                            operand_device)
from repro_torch.core.platform import bind_row_operand, canonical_dtype
from repro_torch.core.rtcg import CudaSourceModule
from repro_torch.core.templates import KernelTemplate

_ROW_REDUCE_TMPL = KernelTemplate.from_file("row_reduce", "row_reduce.cu.j2")
_ELTWISE_TMPL = KernelTemplate.from_file("eltwise_rows", "eltwise_rows.cu.j2")

#: threads per block: wide blocks keep a row's loads in flight when the
#: batch has few rows (the sampler flush has one row per live request)
THREADS = {"row_reduction": 1024, "rows_elementwise": 256,
           "rows_elementwise_scan": 1024}

#: dtype -> (CUDA C type, ctypes scalar type) for the types this slice
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
            f"dtype {dt!r} has no CUDA C binding in this slice "
            f"(supported: {sorted(_CTYPES)})") from None


def _signature(kir):
    """Kernel parameter declarations, call-through names and ctypes
    argtypes of the IR's positional operands (in order)."""
    params, names, argtypes = [], [], []
    for name, dt, kind in kir.args:
        ct = _ctype(dt)
        if kind == "scalar":
            params.append(f"{ct} {name}")
            names.append(name)
            argtypes.append(_CTYPES[dt][1])
        elif kind == "full":
            params += [f"const {ct}* __restrict__ {name}_p",
                       f"long long {name}_s"]
            names += [f"{name}_p", f"{name}_s"]
            argtypes += [ctypes.c_void_p, ctypes.c_longlong]
        else:  # row / col broadcast vectors
            params.append(f"const {ct}* __restrict__ {name}_p")
            names.append(f"{name}_p")
            argtypes.append(ctypes.c_void_p)
    return params, names, argtypes


def _loads(kir, read: set, guard: bool):
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
                load = f"{name}_row[_c]"
                col_loads.append(f"const {ct} {name} = " + (
                    f"_in ? {load} : ({ct})0;" if guard else f"{load};"))
        elif kind == "row" and name in read:
            row_loads.append(f"const {ct} {name} = {name}_p[_r];")
        elif kind == "col" and name in read:
            load = f"{name}_p[_c]"
            col_loads.append(f"const {ct} {name} = " + (
                f"_in ? {load} : ({ct})0;" if guard else f"{load};"))
    return row_loads, col_loads


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
    block_sensitive = False  # sources take b, n and strides at run time

    def fingerprint(self) -> dict:
        return {"backend": self.name, "torch": torch.__version__,
                "cuda": torch.version.cuda or "none", "arch": "sm_90a"}

    # -- render (IR -> CUDA C) ---------------------------------------------
    def render_ir(self, kir) -> str:
        if kir.kind == "elementwise":
            return self._render_elementwise(kir)
        if kir.kind == "reduction":
            return self._render_reduction(kir)
        raise ValueError(f"unknown IR kind {kir.kind!r}")

    def _render_reduction(self, kir) -> str:
        params, names, _ = _signature(kir)
        read = set(kir.meta_get("loaded_vectors", ()))
        row_loads, col_loads = _loads(kir, read, guard=False)
        declared = {a[0] for a in kir.args}
        prelude = [_statement(s, declared, {}) for s in kir.lines("prelude")]
        outs = [dict(ctype=_ctype(o["dtype"]),
                     map_expr=snippets.c_expression(o["map_expr"]),
                     neutral=o["neutral"], combine=o["combine"])
                for o in kir.outs]
        return _ROW_REDUCE_TMPL.render(
            name=kir.name, threads=THREADS["row_reduction"],
            preamble=kir.meta_get("preamble", ""),
            ragged=kir.meta_get("ragged", False),
            params=params, arg_names=names, row_loads=row_loads,
            col_loads=col_loads, prelude_lines=prelude, outs=outs)

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
        for o, ct in out_ctypes.items():   # written vectors live in registers
            if o not in read:
                col_loads.append(f"{ct} {o} = ({ct})0;")
            else:  # read-modify-write: drop the const of its load
                col_loads = [ln.replace(f"const {ct} {o} =", f"{ct} {o} =")
                             for ln in col_loads]
        params, names, _ = _signature(kir)
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

    # -- drivers -----------------------------------------------------------
    def _launcher(self, kir, extra_argtypes) -> Callable:
        """The kernel's entry point, compiled on the driver's first call
        (after its operands passed the device check)."""
        _, _, argtypes = _signature(kir)
        fn = None

        def launch(*cargs) -> int:
            nonlocal fn
            if fn is None:
                mod = CudaSourceModule.load(self.render_ir(kir), name=kir.name)
                fn = mod.get_function(
                    f"{kir.name}_launch",
                    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p] + argtypes + extra_argtypes)
            return fn(*cargs)

        return launch

    @staticmethod
    def _bind(kir, b, n, flat_args, row_lens, ragged):
        device = operand_device(kir, flat_args)
        if device.type != "cuda":
            raise ValueError(
                f"backend 'cuda' launches on CUDA tensors; kernel "
                f"{kir.name!r} got operands on {device} (use backend="
                f"'eager' for CPU tensors)")
        if len(flat_args) != len(kir.args):
            raise TypeError(f"kernel {kir.name!r} takes {len(kir.args)} "
                            f"arguments, got {len(flat_args)}")
        keep = [bind_row_lens(row_lens, b, n, device) if ragged else None]
        cargs = [torch.cuda.current_stream(device).cuda_stream, b, n,
                 keep[0].data_ptr() if ragged else None]
        for (name, dt, kind), arg in zip(kir.args, flat_args):
            if kind == "scalar":   # by value: no device round trip
                v = arg.item() if isinstance(arg, torch.Tensor) else arg
                cargs.append(_PYTYPES[dt](v))
                continue
            t = bind_row_operand(kind, name, arg, canonical_dtype(dt), b, n,
                                 device)
            keep.append(t)
            cargs += [t.data_ptr(), t.stride(0)] if kind == "full" \
                else [t.data_ptr()]
        # `keep` stays referenced by the driver until the launch returns;
        # later reuse of that memory is ordered on the same stream
        return device, cargs, keep

    @staticmethod
    def _check(err: int, kir) -> None:
        if err != 0:
            raise RuntimeError(f"CUDA kernel {kir.name!r} failed to launch: "
                               f"cudaError {err}")

    def build_reduction_rows(self, kir) -> Callable:
        if kir.transposed:
            raise NotImplementedError(
                "axis=0 reductions are ported with ROADMAP Queue 2 item 4")
        dtypes = [canonical_dtype(o["dtype"]) for o in kir.outs]
        launch = self._launcher(kir, [ctypes.c_void_p] * len(dtypes))
        ragged = bool(kir.meta_get("ragged", False))
        multi = kir.meta_get("multi", False)

        def driver(b, n, flat_args, row_lens=None):
            device, cargs, keep = self._bind(kir, b, n, flat_args, row_lens,
                                             ragged)
            outs = [torch.empty(b, dtype=dt, device=device) for dt in dtypes]
            self._check(launch(*cargs, *[o.data_ptr() for o in outs]), kir)
            dispatch.record_kernel_launch("row_reduction")
            del keep
            return tuple(outs) if multi else outs[0]

        return driver

    def build_elementwise_rows(self, kir) -> Callable:
        dtypes = [canonical_dtype(d) for _, d in kir.outs]
        launch = self._launcher(
            kir, [ctypes.c_void_p, ctypes.c_longlong] * len(dtypes))
        ragged = bool(kir.meta_get("ragged", False))

        def driver(b, n, flat_args, row_lens=None):
            device, cargs, keep = self._bind(kir, b, n, flat_args, row_lens,
                                             ragged)
            outs = [torch.empty((b, n), dtype=dt, device=device)
                    for dt in dtypes]
            for o in outs:
                cargs += [o.data_ptr(), o.stride(0)]
            self._check(launch(*cargs), kir)
            dispatch.record_kernel_launch("rows_elementwise")
            del keep
            return outs

        return driver


__all__ = ["CudaBackend", "THREADS"]
