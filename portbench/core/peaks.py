"""Published peaks of one NVIDIA H100 SXM (dense, without sparsity), at its
700 W power limit; a run records the card's own limit beside them."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
