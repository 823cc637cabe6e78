"""attn_roofline.<cell>: attention's share of its roofline over the
traced steps, in %: the least time the chip could take for the work of
every attention call those steps made (each call's larger of bytes over
peak bandwidth and flops over peak rate, bench/kernels/ entries of ROLE
"attention") over the device time of the kernels those entries name."""
from bench import arith


def read(run):
    tl = run.timeline
    p = arith.peaks(run.kind)
    if tl is None or not p:
        return None
    least = busy = 0.0
    for cap in run.captures:
        if cap.entry.ROLE != "attention" or not cap.records:
            continue
        memo = {}
        for r in cap.records:
            key = cap.entry.key(r)
            if key not in memo:
                memo[key] = cap.entry.work(r)
            f, b = memo[key]
            least += max(f / p["bf16_flops_s"], b / p["hbm_bytes_s"])
        busy += sum(s for name, s in tl.kernel_s.items()
                    if any(k in name for k in cap.entry.KERNELS))
    if busy <= 0 or least <= 0:
        return None
    return 100.0 * least / busy
