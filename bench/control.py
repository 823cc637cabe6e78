"""The control of `correct`, read on the card: for each seed one run of
the cell as bench/run.py makes it (set-up, the window at the cell's
load, the program's state freed), then the check twice over the same
served tokens: the program's widest gap against the float32 reference,
and the control's (the reference with its products in float8 e4m3) at
the same positions, each held to the cell's committed limits.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 25

prints one JSON line a seed, with both verdicts: `correct` (the
program's) and `control_correct`, which has to come out false; the limits
in bench/limits/ are set from these readings (PERF.md gives them). Exits
1 where a control came out correct.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    import torch

    from bench import harness, spec, traffic
    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    dev = torch.device("cuda", 0)
    passed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        items = traffic.generate(cell.mix, cell.config["vocab_size"], seed,
                                 args.seconds)
        st = harness.setup(cell, seed, dev)
        rec = harness.window(st, cell, items, args.seconds, False, t0)
        harness.release(st)
        t1 = time.monotonic()
        prog, ctl = harness.judge(cell, rec, st.tree, seed, dev,
                                  control=True)
        passed += harness.correct(ctl)
        print(json.dumps({"seed": seed, "correct": harness.correct(prog),
                          "control_correct": harness.correct(ctl),
                          **{k: v["value"] for k, v in prog.items()},
                          "control_gap": ctl["gap"]["value"],
                          "limit": prog["gap"]["limit"],
                          "check_s": time.monotonic() - t1}), flush=True)
        del st, rec
        torch.cuda.empty_cache()
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
