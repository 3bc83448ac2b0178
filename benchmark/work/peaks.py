"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU
data sheet, dense rates without sparsity).  They assume the card's full
power limit of 700 W; each run prints the card's ``power.limit`` beside its
numbers."""

BF16_DENSE_FLOPS = 989e12   # bf16 / fp16 tensor cores
TF32_DENSE_FLOPS = 495e12
FP32_FLOPS = 67e12          # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3
RATED_POWER_W = 700.0
