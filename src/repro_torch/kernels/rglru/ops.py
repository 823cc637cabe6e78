"""Public RG-LRU scan op: the CUDA kernel on the GPU, the plain version on
the CPU.

The Griffin recurrent block's prefill (models/recurrent.py rglru_block)
closes its linear recurrence h_t = a_t h_{t-1} + b_t over the whole
prompt here; decode takes one step of the same recurrence in plain
tensor code.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_launch, check_tensors, library,
                                 nbytes, reported)
from repro_torch.kernels.rglru.ref import rglru_ref_loop


def _work(a, b, h0=None):
    """No product; a, b and h0 read, h written."""
    return 0, 2 * nbytes(a) + nbytes(b, h0)


@reported(_work)
def rglru_scan(a, b, h0=None):
    """a, b: [B,S,W] f32; h0: [B,W] f32 or None (zeros). Returns h
    [B,S,W] f32.

    CUDA tensors launch the kernel (f32, contiguous, any S >= 1); CPU
    tensors run the plain version; meta tensors give its shape."""
    if a.device.type == "cpu":
        return rglru_ref_loop(a, b, h0)
    if a.device.type == "meta":
        return a.new_empty(a.shape, dtype=torch.float32)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for {a.device}")
    name = "rglru_scan"
    check_tensors(name, a, b, *(() if h0 is None else (h0,)))
    if a.dtype != torch.float32 or b.dtype != torch.float32 or (
            h0 is not None and h0.dtype != torch.float32):
        raise ValueError(f"{name}: a, b and h0 must be f32")
    if a.dim() != 3 or b.shape != a.shape or (
            h0 is not None and h0.shape != (a.shape[0], a.shape[2])):
        raise ValueError(f"{name}: unsupported shapes a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    B, S, W = a.shape
    out = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    if B == 0 or S == 0 or W == 0:
        return out
    rc = library().rglru_scan_f32(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream)
    check_launch(rc, name)
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
