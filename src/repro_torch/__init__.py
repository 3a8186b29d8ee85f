"""repro_torch — the RTCG stack of ``repro`` ported to PyTorch and CUDA.

A second package beside the JAX reference: the same module layout and
names, PyTorch inside.  It imports ``torch`` and never ``jax`` nor
anything of ``repro``.  Its entry points run on the card unless the
caller passes ``device="cpu"``.
"""
