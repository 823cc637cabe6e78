"""Public paged-decode ops: the CUDA kernels on the GPU, the plain versions
on the CPU.

Every attention read of the serving path goes through here: paged decode
rows and prefill lane rows over the block pool, and the contiguous-cache
decode of the one-shot baseline, whose [B,Hkv,S,hd] cache is a pool of B
blocks of S tokens read through the identity table (models/layers.py). So
the baseline and the engine attend with the same arithmetic on either
device, and the greedy --verify compares the serving machinery (paging,
lanes, prefix sharing, copy-on-write), not two softmax reduction orders.

The int8 pool of `--kv quant` (serve/blocks.py QuantBlockManager) is read
by paged_flash_decode_quant; quantize_kv is the write side's quantizer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_launch, check_tensors, library,
                                 nbytes, reported)
from repro_torch.kernels.paged_decode.ref import (paged_decode_quant_ref,
                                                  paged_decode_ref)

# GQA group sizes (Hq / Hkv) the kernels are built for: up to 8 heads sit
# on the N of the kernel's MMAs (5: llama4-scout-17b-a16e's 40 / 8; 7:
# qwen2-vl-7b's 28 / 4), a group of 16 (recurrentgemma-9b) on its M
# (csrc/paged_decode.cuh)
GROUPS = (1, 2, 3, 4, 5, 6, 7, 8, 16)
# Tokens of a row that one block reads, its span: a longer row is split
# over blocks whose partials a second launch merges in span order. Spans
# sit on logical positions, so a row's output does not depend on bs or on
# the other rows. Up to 8 heads: the span covers every table of the
# serving path (96 tokens chunked; 288 at prompt 256, gen 32 in classic
# admission, the slot pool and the one-shot baseline), so none of its rows
# is split; tools/time_paged_decode.py times 256-512 at those tables. A
# group of 16: chip_smoke.py phase 11 times 32, 64, 128 and 256 over
# recurrentgemma-9b's 2048-token rings.
SPAN = 512
SPAN_GQA16 = 64


def span_plan(hd: int, group: int, width: int):
    """(span, n_spans, floats) for rows of head_dim `hd` and a GQA group
    of `group` over tables of `width` logical tokens (MB x bs). The span
    is the group's SPAN, or the width where that is narrower (one span
    then covers the table, and the block's ring is sized to it); n_spans
    = ceil(width / span) covers every span a row can use, and `floats` is
    the workspace one (row, KV head) needs for its partials, group x
    n_spans x (hd + 2) (P.V, then m and l), or 0 when a row is never
    longer than one span. None of them depends on B or on bs."""
    span = min(SPAN_GQA16 if group == 16 else SPAN, width)
    n_spans = -(-width // span)
    return span, n_spans, 0 if n_spans == 1 else group * n_spans * (hd + 2)


def quantize_kv(x, eps: float = 1e-8):
    """Symmetric int8 quantization over the last axis (head_dim): returns
    (int8 values, f32 scales with that axis reduced). scale = absmax/127,
    floored at eps so all-zero rows round-trip to zeros; values round half
    to even and clip to +-127 (the JAX package's quantize_kv)."""
    xf = x.float()
    scale = torch.clamp_min(torch.amax(xf.abs(), dim=-1) / 127.0, eps)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _check_shapes(name, q, k_pool, v_pool, tables, lengths, vec):
    """Shapes both kernels take: GQA group sizes the kernels are built for,
    hd a multiple of the 16-byte load width `vec` with hd/vec a power of
    two up to a warp; pools that start on 16 bytes (the kernel copies
    16-byte slices of their rows)."""
    B, Hq, hd = q.shape
    NB, Hkv, bs, hd_k = k_pool.shape
    tpt = hd // vec
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: tables and lengths must be int32")
    if (hd_k != hd or v_pool.shape != k_pool.shape or tables.dim() != 2
            or tables.shape[0] != B or lengths.shape != (B,)
            or Hq % Hkv or Hq // Hkv not in GROUPS
            or hd % vec or tpt > 32 or tpt & (tpt - 1)):
        raise ValueError(
            f"{name}: unsupported shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}, tables {tuple(tables.shape)}, lengths "
            f"{tuple(lengths.shape)}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: the pools must start on 16 bytes (the "
                         "kernel copies 16-byte slices of their rows)")


def _aligned(q):
    """q, or a copy in a fresh (16-byte aligned) allocation when a view
    starts elsewhere: the kernel reads 16-byte slices of its rows. (The
    int8 pool's f32 scales are read 4 bytes at a time.)"""
    return q if q.data_ptr() % 16 == 0 else q.clone()


def _workspace(q, k_pool, tables):
    """(span, workspace) for the kernel: the span_plan of these shapes and
    a workspace of B x Hkv times its floats (None when no row can be
    longer than one span)."""
    B, Hq, hd = q.shape
    Hkv, bs = k_pool.shape[1], k_pool.shape[2]
    span, _, floats = span_plan(hd, Hq // Hkv, tables.shape[1] * bs)
    if floats == 0:
        return span, None
    return span, torch.empty((B * Hkv * floats,), dtype=torch.float32,
                             device=q.device)


def _table_work(q, k_pool, tables, lengths, scales=()):
    """(flops, bytes) of a paged read: the plain version's scores and P.V
    over each row's whole table (MB x bs positions); q, the blocks each
    row's table names (k and v, with their scales), the tables and
    lengths read, the f32 output written."""
    B, Hq, hd = q.shape
    Hkv, bs = k_pool.shape[1], k_pool.shape[2]
    MB = tables.shape[1]
    scale = scales[0].element_size() if scales else 0
    block = Hkv * bs * (hd * k_pool.element_size() + scale)
    return (4 * B * Hq * MB * bs * hd,
            nbytes(q, tables, lengths) + 2 * B * MB * block
            + 4 * B * Hq * hd)


def _work(q, k_pool, v_pool, tables, lengths):
    return _table_work(q, k_pool, tables, lengths)


def _quant_work(q, k_pool, v_pool, k_scale, v_scale, tables, lengths):
    return _table_work(q, k_pool, tables, lengths, (k_scale, v_scale))


@reported(_work)
def paged_flash_decode(q, k_pool, v_pool, tables, lengths):
    """q [B,Hq,hd]; k_pool/v_pool [NB,Hkv,bs,hd]; tables [B,MB] int32 block
    ids; lengths [B] int32 last valid position (-1: zero row).

    Returns [B,Hq,hd] f32. CUDA tensors launch the kernel (bf16 q and
    pools); CPU tensors run the plain version; meta tensors give its
    shape."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, tables, lengths)
    if q.device.type == "meta":
        return q.new_empty(q.shape, dtype=torch.float32)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: no kernel for {q.device}")
    name = "paged_flash_decode"
    check_tensors(name, q, k_pool, v_pool, tables, lengths)
    if (q.dtype, k_pool.dtype, v_pool.dtype) != (torch.bfloat16,) * 3:
        raise ValueError(f"{name}: q and pools must be bf16")
    _check_shapes(name, q, k_pool, v_pool, tables, lengths, vec=8)
    q = _aligned(q)
    B, Hq, hd = q.shape
    _, Hkv, bs, _ = k_pool.shape
    out = torch.empty((B, Hq, hd), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    span, work = _workspace(q, k_pool, tables)
    rc = library().paged_decode_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, hd, bs,
        tables.shape[1], span, None if work is None else work.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(rc, name)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


@reported(_quant_work)
def paged_flash_decode_quant(q, k_pool, v_pool, k_scale, v_scale, tables,
                             lengths):
    """Quantized paged decode. q [B,Hq,hd] bf16; k_pool/v_pool
    [NB,Hkv,bs,hd] int8; k_scale/v_scale [NB,Hkv,bs] f32 per-row dequant
    scales; tables [B,MB] int32; lengths [B] int32 (-1: zero row).

    Returns [B,Hq,hd] f32. CUDA tensors launch the kernel
    (csrc/paged_decode_quant.cu); CPU tensors run the plain version; meta
    tensors give its shape."""
    if q.device.type == "cpu":
        return paged_decode_quant_ref(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, lengths)
    if q.device.type == "meta":
        return q.new_empty(q.shape, dtype=torch.float32)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_quant: no kernel for {q.device}")
    name = "paged_flash_decode_quant"
    check_tensors(name, q, k_pool, v_pool, k_scale, v_scale, tables, lengths)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: q must be bf16")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise ValueError(f"{name}: pools must be int8")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError(f"{name}: scales must be f32")
    _check_shapes(name, q, k_pool, v_pool, tables, lengths, vec=16)
    if (k_scale.shape != k_pool.shape[:3]
            or v_scale.shape != k_pool.shape[:3]):
        raise ValueError(f"{name}: scales {tuple(k_scale.shape)} and "
                         f"{tuple(v_scale.shape)} do not match pools "
                         f"{tuple(k_pool.shape)}")
    q = _aligned(q)
    B, Hq, hd = q.shape
    _, Hkv, bs, _ = k_pool.shape
    out = torch.empty((B, Hq, hd), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    span, work = _workspace(q, k_pool, tables)
    rc = library().paged_decode_int8(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, hd, bs,
        tables.shape[1], span, None if work is None else work.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(rc, name)
    paged_flash_decode_quant.launches += 1
    return out


paged_flash_decode_quant.launches = 0
