"""RTCG core of the port: snippets -> specs -> kernel IR -> backends.

The kernel families (`ElementwiseKernel`, `ReductionKernel`, the scan
kernels), the loaders (`SourceModule`, `CudaSourceModule`), templating
and the lazy fused arrays (`repro_torch.core.array`) — the JAX package's
``repro.core`` surface minus what waits for its ROADMAP item (the
autotuner, the disk cache, the code builder and the DSL: Queue 1 items 2
and 6).
"""

from repro_torch.core import backends, dispatch
from repro_torch.core.cache import LRUCache, environment_fingerprint, stable_hash
from repro_torch.core.elementwise import ElementwiseKernel
from repro_torch.core.platform import BroadcastArg, ScalarArg, VectorArg
from repro_torch.core.reduction import ReductionKernel
from repro_torch.core.rtcg import CudaSourceModule, SourceModule
from repro_torch.core.scan import (ExclusiveScanKernel, InclusiveScanKernel,
                                   ScanKernel)
from repro_torch.core.templates import KernelTemplate

__all__ = [
    "backends", "dispatch",
    "LRUCache", "environment_fingerprint", "stable_hash",
    "BroadcastArg", "ElementwiseKernel", "ScalarArg", "VectorArg",
    "ReductionKernel", "SourceModule", "CudaSourceModule", "KernelTemplate",
    "ExclusiveScanKernel", "InclusiveScanKernel", "ScanKernel",
]
