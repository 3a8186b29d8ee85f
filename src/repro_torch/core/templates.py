"""Textual templating for kernel generation (paper §5.3, Fig. 5a).

The paper's second codegen strategy: when code variants are textually
related but need control flow (unrolling, conditional sections), use a
templating engine — Jinja2, the engine the paper uses (PyTorch itself
depends on it).  The port renders two kinds of source with it: Python
for the ``eager`` backend (exec'd by `rtcg.SourceModule`) and CUDA C for
the ``cuda`` backend (compiled by `rtcg.CudaSourceModule`, templates
under ``repro_torch/csrc``).  Rendered source is content-addressed by
both loaders, so identical renders are built once.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import jinja2

#: the CUDA C templates of the port's kernels
CSRC = Path(__file__).resolve().parent.parent / "csrc"

_env = jinja2.Environment(
    undefined=jinja2.StrictUndefined,
    trim_blocks=True,
    lstrip_blocks=True,
)


class KernelTemplate:
    """A named, parameterized kernel template.

    >>> t = KernelTemplate("add", '''
    ... def {{ name }}(x, y):
    ...     return x + {{ scale }} * y
    ... ''')
    >>> src = t.render(name="addk", scale=2)   # -> source text
    """

    def __init__(self, entrypoint: str, source: str):
        self.entrypoint = entrypoint
        self.raw = source
        self._template = _env.from_string(source)

    @classmethod
    def from_file(cls, entrypoint: str, filename: str) -> "KernelTemplate":
        """A template kept as a file under ``repro_torch/csrc``."""
        return cls(entrypoint, (CSRC / filename).read_text())

    def render(self, **params: Any) -> str:
        params.setdefault("name", self.entrypoint)
        return self._template.render(**params)
