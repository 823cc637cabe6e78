"""Public flash-decoding ops: one-token GQA attention over a contiguous KV
cache, on one card or over a cache whose sequence axis is split across
ranks (the JAX package's kernels/flash_decode/ops.py).

flash_decode_partials is the counterpart of flash_decode_kernel: the CUDA
kernel (csrc/flash_decode.cu) on a CUDA tensor, the plain version on a CPU
tensor; any other device raises. flash_decode returns its o in q's dtype.
merge_partials combines the partials of the ranks of a torch.distributed
group (one all_reduce MAX of m, two of SUM), merge_partials_stacked those
of slices one process holds (stacked on dim 0). flash_decode_seq_sharded
is the SPMD form: every rank passes its own slice of the sequence.

cur_len is one scalar for the batch, the local index of the last valid
position (-1: every key masked): an int, or a 1-element int32 tensor on
the inputs' device, which the kernel reads there (so a CUDA graph can
capture the call).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import check_launch, check_tensors, library
from repro_torch.kernels.flash_decode.ref import flash_decode_partials_ref

# the kernel's token tile (a span is a whole number of them), by head_dim.
# f32 stages one tile in shared memory at a time: 64 keys up to hd 128, 32
# past it (hd 256 with a GQA group of 16 then takes ~100 KB of shared
# memory). bf16 takes 64 at every hd: its 4 warps walk 32-token chunks (16
# at hd 256), so a 32-token span would leave half of them idle.
TILE_BY_HD = ((128, 64), (256, 32))
BF16_TILE = 64
# splits of the sequence per (row, KV head): enough blocks for about eight
# a streaming multiprocessor, two to three waves of them, which even out
# the last one (chip_smoke.py phase 15 times the alternatives)
BLOCKS_PER_SM = 8


def _cur_len_tensor(cur_len, device):
    """cur_len as a 1-element int32 tensor on `device` (no copy when it
    already is one)."""
    if isinstance(cur_len, torch.Tensor):
        if cur_len.numel() != 1:
            raise ValueError("flash_decode: cur_len is one scalar for the "
                             f"batch, got shape {tuple(cur_len.shape)}")
        return cur_len.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(cur_len)], dtype=torch.int32, device=device)


def _split(B, Hkv, S, hd, dtype, device):
    """(tile, n_split) for the kernel."""
    tile = BF16_TILE if dtype == torch.bfloat16 else next(
        t for h, t in TILE_BY_HD if hd <= h)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-BLOCKS_PER_SM * sms // (B * Hkv))
    return tile, max(1, min(want, -(-S // tile)))


def flash_decode_partials(q, k, v, cur_len):
    """q [B,Hq,hd]; k, v [B,Hkv,S,hd] (f32 or bf16, one dtype); GQA with
    g = Hq/Hkv, scale 1/sqrt(hd); keys at positions <= cur_len.

    Returns (o [B,Hq,hd] f32 normalised, m [B,Hq,1] f32, l [B,Hq,1] f32),
    the partials flash_decode_kernel returns: an all-masked slice gives
    m = -1e30, l = 0, o = 0."""
    if q.device.type == "cpu":
        return flash_decode_partials_ref(q, k, v, cur_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_partials: no kernel for {q.device}")
    name = "flash_decode_partials"
    cur = _cur_len_tensor(cur_len, q.device)
    check_tensors(name, q, k, v, cur)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            (k.dtype, v.dtype) != (q.dtype, q.dtype):
        raise ValueError(f"{name}: q, k and v must be all f32 or all bf16")
    B, Hq, hd = q.shape
    if (k.dim() != 4 or v.shape != k.shape or k.shape[0] != B
            or k.shape[3] != hd or Hq % k.shape[1] or hd % 8 or hd > 256
            or k.shape[2] == 0):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if any(t.data_ptr() % 16 for t in (k, v)):
        raise ValueError(f"{name}: k and v must start on 16 bytes (the "
                         "kernel reads 16-byte slices of their rows)")
    Hkv, S = k.shape[1], k.shape[2]
    o = torch.empty((B, Hq, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hq, 1), dtype=torch.float32, device=q.device)
    if B == 0:
        return o, m, l
    tile, n_split = _split(B, Hkv, S, hd, q.dtype, q.device)
    work = torch.empty((B * Hq * n_split * (hd + 2),), dtype=torch.float32,
                       device=q.device)
    rc = library().flash_decode_partials(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cur.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), work.data_ptr(), B, Hq,
        Hkv, S, hd, tile, n_split, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(rc, name)
    flash_decode_partials.launches += 1
    return o, m, l


flash_decode_partials.launches = 0


def flash_decode(q, k, v, cur_len):
    """Unsharded decode attention: q [B,Hq,hd]; k, v [B,Hkv,S,hd].
    Returns [B,Hq,hd] in q's dtype."""
    return flash_decode_partials(q, k, v, cur_len)[0].to(q.dtype)


def merge_partials(o, m, l, group=None):
    """LSE-merge the partials of the ranks of `group` (kernel.py
    merge_partials): o [B,Hq,hd] f32 normalised per rank, m, l [B,Hq,1].
    An all-masked rank has l = 0, so zero weight."""
    from repro_torch.parallel.collectives import count
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    w = l * torch.exp(m - m_g)
    num = o * w
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(num, op=dist.ReduceOp.SUM, group=group)
    for x in (m_g, w, num):
        count("all-reduce", x)
    return num / torch.clamp_min(w, 1e-30)


def merge_partials_stacked(o, m, l):
    """merge_partials over slices one process holds, stacked on dim 0:
    o [n,B,Hq,hd], m, l [n,B,Hq,1]."""
    w = l * torch.exp(m - m.amax(0, keepdim=True))
    return (o * w).sum(0) / torch.clamp_min(w.sum(0), 1e-30)


def flash_decode_seq_sharded(q, k_local, v_local, cur_len, group=None,
                             index=None):
    """Flash-decoding over a cache whose sequence axis is split evenly
    across the ranks of `group`: each rank passes q (the same on every
    rank) and its own slice k_local, v_local [B,Hkv,S/world,hd], slice
    `index` of the sequence (default: the rank's place in the group; a
    DeviceMesh passes its coordinate along the axis); cur_len is the
    global index of the last valid position, an int or a [1] int tensor
    on q's device (no host sync). Each rank attends to its slice up to
    clamp(cur_len - index * s_local, -1, s_local - 1) through
    flash_decode_partials (the kernel on a CUDA tensor, the plain version
    on a CPU one) and the partials merge across the group (ops.py
    flash_decode_seq_sharded). Returns [B,Hq,hd] in q's dtype on every
    rank."""
    s_local = k_local.shape[2]
    if index is None:
        index = dist.get_rank(group)
    start = index * s_local
    if isinstance(cur_len, torch.Tensor):
        local = (cur_len.reshape(1).to(q.device) - start).clamp(
            -1, s_local - 1).to(torch.int32)
    else:
        local = min(max(int(cur_len) - start, -1), s_local - 1)
    o, m, l = flash_decode_partials(q, k_local, v_local, local)
    return merge_partials(o, m, l, group).to(q.dtype)
