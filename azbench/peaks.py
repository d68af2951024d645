"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). A card set below 700 W
runs slower under load: every result carries the card's power limit."""

BF16_FLOPS = 989e12  # bf16 / fp16 tensor cores
INT8_OPS = 1979e12  # int8 tensor cores (fp8 the same)
TF32_FLOPS = 495e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

#: The tensor-core peak of each compute precision a configuration states.
PEAK_OF = {"int8": INT8_OPS, "bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
           "tf32": TF32_FLOPS, "float32": F32_FLOPS}
