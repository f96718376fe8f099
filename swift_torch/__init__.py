"""swift_torch -- the PyTorch and CUDA port of swift_tpu for NVIDIA Hopper.

It mirrors ``swift_tpu``'s module names. Plain tensor code is PyTorch; each
Pallas kernel of the JAX package on the ported path is a kernel written by
hand for ``sm_90a`` (CUDA C++ under ``csrc/``, or Triton), with a plain
PyTorch version beside it that CPU tensors take. The package never imports
jax; it reuses swift_tpu's numpy-only modules (datasets, variable lists,
zarr stores, configs) and imports those that need h5py or yaml lazily.
Layout is channels-last ``(B, gh, gw, D)`` throughout.
"""

__version__ = "0.1.0"
