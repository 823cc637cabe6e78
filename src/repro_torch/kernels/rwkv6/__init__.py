"""RWKV-6 WKV recurrence: CUDA kernel (csrc/wkv6.cu) + plain version."""
