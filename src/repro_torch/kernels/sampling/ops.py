"""Public fused top-k/top-p mask op: the CUDA kernel on the GPU, the
sort-based plain version on the CPU — the same keep-set either way, so
seeded sampling means the same thing on both devices. Rows of any width:
up to MAX_VOCAB logits the kernel stages a row in one block's shared
memory, up to CLUSTER * MAX_VOCAB it splits the row over a cluster of
CLUSTER blocks' shared memory, past that one block reads the row from
global memory on each pass (csrc/topk_topp_mask.cu picks by V)."""
from __future__ import annotations

import torch

from repro_torch.kernels import check_launch, check_tensors, library
from repro_torch.kernels.sampling.ref import topk_topp_mask_ref

# widest row one block stages in shared memory (csrc kMaxRowBytes / 4),
# and the blocks of a cluster a wider row is split over (csrc kCluster)
MAX_VOCAB = (227 * 1024 - 1024) // 4
CLUSTER = 8


def topk_topp_mask(logits, top_k, top_p):
    """logits [T,V] f32; top_k [T] int32 (<=0 off); top_p [T] f32 (>=1 off).

    Returns [T,V] f32: kept logits unchanged, dropped entries at -1e30."""
    if logits.device.type == "cpu":
        return topk_topp_mask_ref(logits, top_k, top_p)
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
