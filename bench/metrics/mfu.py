"""mfu.<cell>: model flops the traffic needed over the window's wall
time, as a share of the card's bf16 peak, in %.

Flops are the benchmark's own count (bench/arith.py), the same whatever
implements the step: for every request that got its first token in the
window, its prompt's positions (a shared document once a run, for the
first request that got a token after it), and one position for every
further output token that reached the host in the window. A prompt whose
prefill had not finished when a window without drain closed is not
counted, nor one that finished before the window opened."""
import math

from bench import arith


def read(run):
    peak = arith.peaks(run.kind).get("bf16_flops_s")
    span = run.t_stop - run.t_open
    if not peak or span <= 0:
        return None
    shared = bool(run.mix["prompt"].get("shared"))
    seen = set()
    flops = 0.0
    order = sorted(range(len(run.items)),
                   key=lambda i: run.stamps[i][0] if run.stamps[i]
                   else math.inf)
    for i in order:
        st = run.stamps[i]
        if not st:
            continue
        it = run.items[i]
        P = len(it.prompt)
        if st[0] > run.t_open:
            lo = it.doc_len if shared and it.doc in seen else 0
            flops += arith.span_flops(run.cfg, lo, P)
        seen.add(it.doc)
        # token k (k >= 1) is made by the row at position P + k - 1
        k0 = max(1, next((k for k, t in enumerate(st) if t > run.t_open),
                         len(st)))
        flops += arith.span_flops(run.cfg, P + k0 - 1, P + len(st) - 1)
    return 100.0 * flops / span / peak
