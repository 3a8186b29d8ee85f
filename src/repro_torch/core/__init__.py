"""RTCG core of the port: snippets -> specs -> kernel IR -> backends."""

from repro_torch.core.elementwise import ElementwiseKernel
from repro_torch.core.platform import BroadcastArg, ScalarArg, VectorArg
from repro_torch.core.reduction import ReductionKernel

__all__ = ["ElementwiseKernel", "ReductionKernel", "BroadcastArg",
           "ScalarArg", "VectorArg"]
