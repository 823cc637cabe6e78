"""RG-LRU linear recurrence: CUDA kernel (csrc/rglru_scan.cu) + plain
version."""
