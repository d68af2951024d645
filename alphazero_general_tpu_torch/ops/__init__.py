"""Hand-written CUDA kernels with their plain PyTorch versions.

* ``descend`` — the PUCT walk (replaces the Pallas ``_descend_kernel``);
* ``backup`` — leaf-to-root value propagation (replaces ``_backup_kernel``);
* ``build`` — compiles ``csrc/*.cu`` with nvcc on first use and loads the
  library with ctypes.
"""
