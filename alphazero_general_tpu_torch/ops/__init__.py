"""Hand-written CUDA kernels with their plain PyTorch versions.

* ``descend`` — the PUCT walk (replaces the Pallas ``_descend_kernel``),
  over game-minor or batch-major tree columns;
* ``backup`` — leaf-to-root value propagation (replaces ``_backup_kernel``),
  over either layout;
* the int8 tower's fused 3x3 conv (``csrc/conv_int8.cu``), whose wrappers
  ``conv_quantize`` and ``conv_residual`` live beside their plain versions
  in ``models/quant.py``;
* ``build`` — compiles ``csrc/*.cu`` with nvcc on first use and loads the
  library with ctypes.
"""
