"""Public paged-decode op: the CUDA kernel on the GPU, the plain version on
the CPU.

Every attention read of the serving path goes through here: paged decode
rows and prefill lane rows over the block pool, and the contiguous-cache
decode of the one-shot baseline, whose [B,Hkv,S,hd] cache is a pool of B
blocks of S tokens read through the identity table (models/layers.py). So
the baseline and the engine attend with the same arithmetic on either
device, and the greedy --verify compares the serving machinery (paging,
lanes, prefix sharing, copy-on-write), not two softmax reduction orders.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_launch, check_tensors, library
from repro_torch.kernels.paged_decode.ref import paged_decode_ref


def paged_flash_decode(q, k_pool, v_pool, tables, lengths):
    """q [B,Hq,hd]; k_pool/v_pool [NB,Hkv,bs,hd]; tables [B,MB] int32 block
    ids; lengths [B] int32 last valid position (-1: zero row).

    Returns [B,Hq,hd] f32. CUDA tensors launch the kernel (bf16 q and
    pools); CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: no kernel for {q.device}")
    name = "paged_flash_decode"
    check_tensors(name, q, k_pool, v_pool, tables, lengths)
    B, Hq, hd = q.shape
    NB, Hkv, bs, hd_k = k_pool.shape
    if (q.dtype, k_pool.dtype, v_pool.dtype) != (torch.bfloat16,) * 3:
        raise ValueError(f"{name}: q and pools must be bf16")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: tables and lengths must be int32")
    if (hd_k != hd or v_pool.shape != k_pool.shape or tables.dim() != 2
            or tables.shape[0] != B or lengths.shape != (B,)
            or Hq % Hkv or Hq // Hkv not in (1, 2, 3, 4, 6, 8)
            or hd % 8 or hd // 8 > 32 or (hd // 8) & (hd // 8 - 1)):
        raise ValueError(
            f"{name}: unsupported shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}, tables {tuple(tables.shape)}, lengths "
            f"{tuple(lengths.shape)}")
    out = torch.empty((B, Hq, hd), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    rc = library().paged_decode_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, hd, bs,
        tables.shape[1], torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(rc, name)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
