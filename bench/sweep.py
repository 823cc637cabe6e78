"""Find the highest rate a Poisson cell sustains: one process, one
engine, one window per offered rate (each with its own traffic seed),
every request followed to its end.

    python3 bench/sweep.py --workload <cell> --rates 0.5,1,2 --seconds 30 --seed 7

prints one JSON line per rate: offered and completed requests per
second, TTFT percentiles of the first and the last third of the
arrivals, the requests due but not admitted when the window closed, the
drain after the close, and whether the rate is sustained: at the close
at most 3% of the requests (or 2) still wait for a slot, the last
third's median TTFT at most twice the first third's plus 0.5 s (no
backlog that grows through the window), and no request left unserved.
The window has to be long enough for the slots to fill. The cell's rate
is then fixed in its traffic file.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]


def stats(rec):
    from bench import arith

    n = len(rec.items)
    ttft = [(s[0] - rec.due(i)) if s else float("inf")
            for i, s in enumerate(rec.stamps)]
    third = max(n // 3, 1)
    first = statistics.median(ttft[:third])
    last = statistics.median(ttft[-third:])
    done = [r.t_done for r in rec.reqs if r.t_done is not None]
    unserved = n - len(done)
    waiting = sum(1 for i, r in enumerate(rec.reqs)
                  if r.t_admit is None or r.t_admit > rec.t_close)
    return {"requests": n,
            "offered_rps": n / (rec.t_close - rec.t_open),
            "completed_in_window_rps": sum(
                1 for t in done if t <= rec.t_close) / (rec.t_close
                                                        - rec.t_open),
            "ttft_p50_first_third_s": first, "ttft_p50_last_third_s": last,
            "ttft_p90_s": arith.nearest_rank(ttft, 90)[0],
            "drain_s": (max(done) - rec.t_close) if done else None,
            "waiting_at_close": waiting, "unserved": unserved,
            "sustained": (unserved == 0 and last <= 2 * first + 0.5
                          and waiting <= max(2, 0.03 * n))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    from bench import harness, spec, traffic
    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    dev = torch.device("cuda", 0)
    st = harness.setup(cell, args.seed, dev)
    print(json.dumps({"setup_s": time.monotonic() - T_START,
                      "kind": str(dev)}), flush=True)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        c = copy.deepcopy(cell)
        c.mix["arrivals"]["rate_rps"] = rate
        items = traffic.generate(c.mix, c.config["vocab_size"],
                                 args.seed + 1 + k, args.seconds)
        rec = harness.window(st, c, items, args.seconds, False, T_START)
        print(json.dumps({"rate_rps": rate, **stats(rec)}), flush=True)


if __name__ == "__main__":
    main()
