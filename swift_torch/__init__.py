"""swift_torch -- the PyTorch and CUDA port of swift_tpu for NVIDIA Hopper.

It mirrors ``swift_tpu``'s module names. Plain tensor code is PyTorch; each
Pallas kernel of the JAX package on the ported path is a kernel written by
hand for ``sm_90a`` in CUDA C++ under ``csrc/``, with a plain PyTorch
version beside it that CPU tensors take. The package imports
nothing of jax and nothing of swift_tpu: it keeps its own copies of the
numpy-only modules it needs (datasets, samplers, variable lists, zarr
stores, config composition) and reads swift_tpu's YAML config tree as data.
Layout is channels-last ``(B, gh, gw, D)`` throughout.
"""

__version__ = "0.1.0"
