"""Public WKV6 op: the CUDA kernel on the GPU, the plain version on the
CPU.

The RWKV-6 time mix's prefill (models/recurrent.py rwkv_time_mix) runs
its whole prompt through here, from a zero state, and keeps the final
state for decode; decode takes one step of the same recurrence in plain
tensor code (rwkv_time_mix_step).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_launch, check_tensors, library,
                                 nbytes, reported)
from repro_torch.kernels.rwkv6.ref import wkv6_ref

HEAD_DIMS = (16, 32, 64)  # the kernel's instantiations


def _work(r, k, v, logw, u):
    """The plain version's readout r_t^T (S + diag(u) k_t v_t^T) at every
    step (ref.py's einsum); r, k, v, logw and u read, o (f32) and the
    final state (f32) written."""
    B, S, H, hd = r.shape
    return (2 * B * S * H * hd * hd,
            nbytes(r, k, v, logw, u) + 4 * (B * S * H * hd + B * H * hd * hd))


@reported(_work)
def wkv6(r, k, v, logw, u):
    """r, k, v: [B,S,H,hd] (model layout, bf16 from the projections);
    logw: [B,S,H,hd] f32 (log decay, <= 0); u: [H,hd] f32 (bonus).
    Returns (o [B,S,H,hd] f32, s_final [B,H,hd,hd] f32).

    CUDA tensors launch the kernel (those dtypes, contiguous, hd in
    HEAD_DIMS, any S >= 1); CPU tensors run the plain version; meta
    tensors give its shapes."""
    if r.device.type == "cpu":
        o, s = wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, logw)), u)
        return o.transpose(1, 2), s
    if r.device.type == "meta":
        B, S, H, hd = r.shape
        return (r.new_empty(r.shape, dtype=torch.float32),
                r.new_empty((B, H, hd, hd), dtype=torch.float32))
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for {r.device}")
    name = "wkv6"
    check_tensors(name, r, k, v, logw, u)
    if (r.dtype, k.dtype, v.dtype) != (torch.bfloat16,) * 3:
        raise ValueError(f"{name}: r, k and v must be bf16")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"{name}: logw and u must be f32")
    B, S, H, hd = r.shape
    if (r.dim() != 4 or k.shape != r.shape or v.shape != r.shape
            or logw.shape != r.shape or u.shape != (H, hd)
            or hd not in HEAD_DIMS):
        raise ValueError(f"{name}: unsupported shapes r {tuple(r.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}")
    o = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B == 0 or H == 0:
        return o, s
    if S == 0:
        return o, s.zero_()
    # the kernel stages 16-byte pieces: an input at an odd offset into its
    # storage is copied to a fresh (aligned) allocation first
    r, k, v, logw = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (r, k, v, logw))
    rc = library().wkv6_bf16(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), o.data_ptr(), s.data_ptr(), B, S, H, hd,
        torch.cuda.current_stream(r.device).cuda_stream)
    check_launch(rc, name)
    wkv6.launches += 1
    return o, s


wkv6.launches = 0
