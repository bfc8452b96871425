"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit). A share of a roofline
is stated against these, with the card's power limit printed beside it."""

BF16_FLOPS = 989e12  # tensor cores, dense bf16/fp16, flop/s
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12  # CUDA cores; an FMA counts as two flops
FP32_INSTR = FP32_FLOPS / 2  # FP32 instructions a second (one FMA or one add each)
HBM_BYTES = 3.35e12  # bytes/s
