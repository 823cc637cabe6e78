"""Flash attention: CUDA kernel (csrc/flash_attention.cu) + plain version."""
