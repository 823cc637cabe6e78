"""Top-k/top-p logit mask: CUDA kernel (csrc/topk_topp_mask.cu) + plain version."""
