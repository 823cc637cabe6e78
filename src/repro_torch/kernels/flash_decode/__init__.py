"""Flash-decoding over a contiguous KV cache, sharded or not: CUDA kernel
(csrc/flash_decode.cu) + plain version."""
