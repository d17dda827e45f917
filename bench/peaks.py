"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data sheet:
dense rates without sparsity, at the full 700 W power limit."""

#: float32 outside the tensor cores, FLOP/s
F32_FLOP_PER_S = 67e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
