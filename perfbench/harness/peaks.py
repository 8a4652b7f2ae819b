"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
#: float32 outside the tensor cores; also the bound used for integer ALU
#: work (one operation a counter row a word)
F32_FLOPS = 67e12
ALU_OPS_PER_S = 67e12
MEMORY_BYTES = 80e9
