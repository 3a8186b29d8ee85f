"""Serving engines of the port."""

from repro_torch.serving.engine import (ContinuousEngine, Engine,
                                        GenerationResult, RequestQueue,
                                        ServedResult)

__all__ = ["ContinuousEngine", "Engine", "GenerationResult", "RequestQueue",
           "ServedResult"]
