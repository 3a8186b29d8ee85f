"""Run-time code generation core — two content-addressed loaders (paper §5).

PyCUDA turns a CUDA-C string into a loaded GPU binary at run time and
caches the binary by content.  The port has one loader per backend:

  * `SourceModule` exec's generated *Python* source (the ``eager``
    backend's torch code) into a namespace, registered with `linecache`
    so tracebacks show the generated lines;
  * `CudaSourceModule` is PyCUDA's ``SourceModule`` itself: it writes the
    rendered CUDA C to a ``.cu`` file, compiles it with ``nvcc`` for
    ``sm_90a`` into a shared library with a plain C entry point, and
    loads that with `ctypes`.  The library is named by
    ``sha256(source + nvcc flags + nvcc --version)`` inside the build
    directory (``REPRO_TORCH_BUILD_DIR``, default ``build/rtcg_kernels``
    at the repository root), so an identical render never recompiles —
    across processes too.

The user never touches the compiler; source goes in, a callable comes
out (Fig. 2 workflow).
"""

from __future__ import annotations

import ctypes
import functools
import linecache
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Callable

from repro_torch.core.cache import LRUCache, stable_hash

_module_registry: LRUCache = LRUCache(maxsize=512)


def _default_namespace() -> dict[str, Any]:
    """Names available to generated Python source — the 'runtime
    library' the eager kernels link against."""
    import torch

    from repro_torch.core import snippets

    return {"torch": torch, "_c": snippets.TORCH_NAMESPACE}


class SourceModule:
    """Exec generated Python source into callables.

    >>> mod = SourceModule('''
    ... def multiply_by_two(x):
    ...     return x * 2
    ... ''')
    >>> f = mod.get_function("multiply_by_two")
    """

    def __init__(self, source: str, name: str | None = None):
        self.source = source
        self.key = stable_hash(source)
        self.name = name or f"rtcg_{self.key[:12]}"
        self._ns = _default_namespace()
        # Register the source with linecache so tracebacks/introspection
        # show generated code (error reporting is a paper requirement).
        fname = f"<rtcg:{self.name}>"
        linecache.cache[fname] = (len(source), None, source.splitlines(True), fname)
        code = compile(source, fname, "exec")
        exec(code, self._ns)

    @classmethod
    def load(cls, source: str, name: str | None = None) -> "SourceModule":
        """Content-addressed load: identical source -> same module."""
        return _module_registry.get_or_create(
            stable_hash(source), lambda: cls(source, name=name))

    def get_function(self, name: str) -> Callable:
        try:
            fn = self._ns[name]
        except KeyError:
            raise NameError(
                f"generated module {self.name!r} defines no function {name!r}"
            ) from None
        if not callable(fn):
            raise TypeError(f"{name!r} in generated module is not callable")
        return fn


# ------------------------------------------------------------- CUDA C
#: nvcc flags of every generated kernel: Hopper's ``sm_90a`` target, a
#: shared library with a plain C interface, and the compiler's resource
#: report (registers, shared memory, spills) kept as the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "rtcg_kernels"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the cuda "
                       "backend compiles its kernels at run time")


@functools.lru_cache(maxsize=1)
def nvcc_version() -> str:
    return subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout


def check_launch(err: int, name: str) -> None:
    """Raise on the non-zero CUDA error code a launch function returned
    (a refused launch never runs, and no later synchronize reports it)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: "
                           f"cudaError {err}")


class CudaSourceModule:
    """Compile CUDA C source into a loaded shared library.

    Mirrors ``pycuda.compiler.SourceModule``: ``get_function(name,
    argtypes)`` returns the ``extern "C"`` entry point with its ctypes
    signature set.  Entry points return a CUDA error code (``int``).
    """

    def __init__(self, source: str, name: str = "rtcg"):
        self.source = source
        self.name = name
        self.key = stable_hash(
            "\0".join([source, " ".join(NVCC_FLAGS), nvcc_version()]))
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        self.path = out / f"{name}-{self.key[:24]}.so"
        self.build_log = ""
        self.compiled = False
        if not self.path.exists():
            self._compile()
        self._lib = ctypes.CDLL(str(self.path))

    def _compile(self) -> None:
        src = self.path.with_suffix(".cu")
        tag = f".{os.getpid()}.{threading.get_ident()}.tmp"
        tmp_src = Path(str(src) + tag + ".cu")
        tmp_lib = Path(str(self.path) + tag + ".so")
        tmp_src.write_text(self.source)
        try:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp_lib), str(tmp_src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on generated kernel {self.name!r} "
                    f"(exit {proc.returncode}):\n{proc.stderr[-6000:]}\n"
                    f"--- source ---\n{self.source}")
            self.build_log = proc.stdout + proc.stderr
            # concurrent builders of one key: each writes its own temp
            # files, the renames are atomic and the contents identical
            os.replace(tmp_src, src)
            os.replace(tmp_lib, self.path)
            self.compiled = True
        finally:
            for p in (tmp_src, tmp_lib):
                if p.exists():
                    p.unlink()

    @classmethod
    def load(cls, source: str, name: str = "rtcg") -> "CudaSourceModule":
        """Content-addressed load: identical source -> same module."""
        return _module_registry.get_or_create(
            ("cuda", stable_hash(source)), lambda: cls(source, name=name))

    def get_function(self, name: str, argtypes) -> Callable:
        fn = getattr(self._lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn
