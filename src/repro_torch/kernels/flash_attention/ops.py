"""Public flash-attention op: the CUDA kernel on the GPU, the plain version
on the CPU.

Full-sequence attention of a classic (batch-1 or batched) prefill: every
query row attends over the prompt's keys with a causal or sliding-window
mask. models/model.py calls it for prompts longer than 128 tokens, as the
JAX package's pallas plan does (`Sq > 128`); shorter prompts take
models/layers.py attention_naive.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_launch, check_tensors, library,
                                 nbytes, reported)
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations


def _work(q, k, v, **_):
    """The plain version's scores and P.V over every (query, key) pair;
    q, k and v read, the output written."""
    B, Sq, Hq, hd = q.shape
    return 4 * B * Hq * Sq * k.shape[1] * hd, 2 * nbytes(q) + nbytes(k, v)


@reported(_work)
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    n_kv_heads: int | None = None):
    """q: [B,Sq,Hq,hd], k/v: [B,Sk,Hkv,hd] (model layout) -> [B,Sq,Hq*hd]
    in q.dtype.

    CUDA tensors launch the kernel (bf16, contiguous, hd in HEAD_DIMS);
    CPU tensors run the plain version; meta tensors give its shape."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if n_kv_heads is not None and n_kv_heads != Hkv:
        raise ValueError(f"flash_attention: n_kv_heads={n_kv_heads} but k "
                         f"has {Hkv} heads")
    if q.device.type == "cpu":
        o = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
        return o.transpose(1, 2).reshape(B, Sq, Hq * hd)
    if q.device.type == "meta":
        return q.new_empty((B, Sq, Hq * hd))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    name = "flash_attention"
    check_tensors(name, q, k, v)
    if (q.dtype, k.dtype, v.dtype) != (torch.bfloat16,) * 3:
        raise ValueError(f"{name}: q, k and v must be bf16")
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or Hq % Hkv or hd not in HEAD_DIMS or window < 0):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"window {window}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start on 16 bytes (the "
                         "kernel copies 16-byte slices of their rows)")
    out = torch.empty((B, Sq, Hq * hd), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    if Sk == 0:
        raise ValueError(f"{name}: no keys to attend (Sk = 0)")
    rc = library().flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        Hq, Hkv, hd, int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(rc, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
