"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit). Rooflines are stated against these, with
the card's power limit beside them."""

BYTES_S = 3.35e12      # HBM3
BF16_FLOP_S = 989e12   # bf16 / fp16 tensor cores
FP32_FLOP_S = 67e12    # float32 outside the tensor cores
