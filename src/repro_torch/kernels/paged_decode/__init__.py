"""Paged decode attention: CUDA kernel (csrc/paged_decode.cu) + plain version."""
