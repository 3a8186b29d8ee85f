# Hand-written CUDA kernels for the compute hot spots.  Each subpackage:
# <name>.py (the kernel's wrapper, which renders and builds
# repro_torch/csrc/<name>.cu.j2, beside its plain torch version), ops.py
# (the entry points), ref.py (the oracle).
