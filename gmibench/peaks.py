"""Published peaks of the chip the benchmark runs on: NVIDIA's data sheet
for the H100 SXM (dense rates without sparsity, at its 700 W limit).  A
card set below 700 W reaches less; each result line gives the card's
power limit beside its shares."""

HBM_BYTES_PER_S = 3.35e12   # HBM3
TF32_DENSE = 495e12         # tensor cores, TF32 inputs, dense
FP32 = 67e12                # float32 outside the tensor cores
