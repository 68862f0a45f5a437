"""Hand-written Hopper kernels of the port. Each ``<name>/`` package
holds ``ops.py`` (the checked wrapper with its launch counter) and
``ref.py`` (the plain PyTorch version); the CUDA sources live in
``repro_torch/csrc/`` and are built by ``_build.py``."""
