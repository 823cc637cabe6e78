"""Kernel-work entry: #1, the paged decode attention (decode rows and
prefill lane rows over the block pool), csrc/paged_decode.cu through
repro_torch.kernels.paged_decode.ops.paged_flash_decode.

Work of one call: every KV block the rows' tables reference up to each
row's depth, read once (K and V), q read once, the float32 output written
once, the tables and lengths read; flops 4 x heads x head_dim for every
key a row attends to (scores and P.V)."""
import torch

OP = "repro_torch.kernels.paged_decode.ops:paged_flash_decode"
ROLE = "attention"
KERNELS = ("paged_decode_kernel", "paged_decode_merge_kernel")


def capture(q, k_pool, v_pool, tables, lengths):
    """What the work needs, holding no large tensor: the shapes, and the
    tables and lengths (small; read after the trace)."""
    return (tuple(q.shape), q.element_size(), tuple(k_pool.shape),
            k_pool.element_size(), tables, lengths)


def key(rec):
    return (rec[0], rec[2], rec[4].data_ptr(), rec[5].data_ptr())


def work(rec):
    (B, Hq, hd), qb, (NB, Hkv, bs, _), kb, tables, lengths = rec
    t = tables.cpu().long()
    n = lengths.cpu().long()
    live = n >= 0
    blocks = set()
    for b in torch.nonzero(live).flatten().tolist():
        blocks.update(t[b, :int(n[b]) // bs + 1].tolist())
    keys = int((n[live] + 1).sum())
    flops = 4 * Hq * hd * keys
    read = (len(blocks) * 2 * Hkv * bs * hd * kb + B * Hq * hd * qb
            + t.numel() * 4 + n.numel() * 4)
    return float(flops), float(read + B * Hq * hd * 4)
