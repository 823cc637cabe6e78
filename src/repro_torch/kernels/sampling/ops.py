"""Public fused top-k/top-p mask op: the CUDA kernel on the GPU, the
sort-based plain version on the CPU — the same keep-set either way, so
seeded sampling means the same thing on both devices. The kernel finds
both thresholds by a radix select over the row held on chip
(csrc/topk_topp_mask.cu). Rows of any width: up to MAX_VOCAB logits one
block stages a row in shared memory, up to CLUSTER * MAX_SHARE a cluster
of 2, 4 or CLUSTER blocks each stages a share of at most MAX_SHARE, past
that a cluster of CLUSTER blocks reads its shares from device memory on
each pass (the kernel picks by V alone, so a row's bits never depend on
how many rows share the call). A row of any alignment is taken: the kernel copies 16 bytes at a
time where the row starts on 16 bytes, 4 bytes at its ragged ends."""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_launch, check_tensors, library,
                                 nbytes, reported)
from repro_torch.kernels.sampling.ref import topk_topp_mask_ref

# widest row one block stages in shared memory (csrc kMaxShared: 227 KB
# less 3 KB of static scratch, two histograms of 2 x 2080 32-bit words and
# the 4 KB candidate list, in f32, less 8 of slack), a cluster block's
# widest share (a third histogram: csrc kMaxShare), and the largest
# cluster (csrc kMaxCluster)
MAX_VOCAB = (227 * 1024 - 3072 - 2 * 16640 - 4096) // 4 - 8
MAX_SHARE = (227 * 1024 - 3072 - 3 * 16640 - 4096) // 4 - 8
CLUSTER = 8


def _work(logits, top_k, top_p):
    """No product; the rows and their settings read, the masked rows
    written (f32)."""
    return 0, nbytes(logits, top_k, top_p) + 4 * logits.numel()


@reported(_work)
def topk_topp_mask(logits, top_k, top_p):
    """logits [T,V] f32; top_k [T] int32 (<=0 off); top_p [T] f32 (>=1 off).

    Returns [T,V] f32: kept logits unchanged, dropped entries at -1e30
    (on meta tensors an empty result of that shape)."""
    if logits.device.type == "cpu":
        return topk_topp_mask_ref(logits, top_k, top_p)
    if logits.device.type == "meta":
        return logits.new_empty(logits.shape, dtype=torch.float32)
    if logits.device.type != "cuda":
        raise ValueError(f"topk_topp_mask: no kernel for {logits.device}")
    name = "topk_topp_mask"
    check_tensors(name, logits, top_k, top_p)
    if (logits.dtype, top_k.dtype, top_p.dtype) != (
            torch.float32, torch.int32, torch.float32):
        raise ValueError(f"{name}: logits f32, top_k int32, top_p f32")
    if logits.dim() != 2 or top_k.shape != (logits.shape[0],) \
            or top_p.shape != (logits.shape[0],):
        raise ValueError(f"{name}: logits {tuple(logits.shape)}, top_k "
                         f"{tuple(top_k.shape)}, top_p {tuple(top_p.shape)}")
    T, V = logits.shape
    out = torch.empty_like(logits)
    if T == 0 or V == 0:
        return out
    rc = library().topk_topp_mask_f32(
        logits.data_ptr(), top_k.data_ptr(), top_p.data_ptr(),
        out.data_ptr(), T, V,
        torch.cuda.current_stream(logits.device).cuda_stream)
    check_launch(rc, name)
    topk_topp_mask.launches += 1
    return out


topk_topp_mask.launches = 0
