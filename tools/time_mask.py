"""Device time of the top-k/top-p mask (#2) at the shapes and settings
chip_smoke.py phases 5 and 15 time it at, for the tree at --root
(default: this checkout), so that two trees can be timed one after the
other on one card:

  python3 tools/time_mask.py [--root DIR] [--seed 0]

Shapes (T rows x V logits): 72 x 32000, paper-demo-110m's sampled step
(8 decode rows and a 64-row prefill lane); 8 rows of 57857, 65536
(rwkv6-1.6b), 256000 (recurrentgemma-9b) and 462849 logits (past the
widest cluster of shared memory; no serving path). Settings, each row's
(top_k, top_p):
  mix     at 72 rows phase 2's mix (k 0, 1, 5, 40, 50, V, V + 7, 8 by
          row, p 1, 0.9, 0.5, 0.25, 1e-3, 0.95, 1, 0.999 by blocks of 9
          rows), at 8 rows phase 15's; row 2 holds 8 tied maxima;
  serve   k 50, p 0.9 on every row (the seeded serves' settings);
  p_only  k 0, p 0.9;
  copy    k 0, p 1: nothing to mask.
Logits are N(0, 3^2) from a seeded generator on the card. Each case is
held to the plain version (torch.equal) and timed as a CUDA graph of
calls replayed (CUDA events, us a call) beside the plain version and one
torch.sort of the logits. Prints one JSON object.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

from time_paged_decode import device_us

SHAPES = [(72, 32000), (8, 57857), (8, 65536), (8, 256000), (8, 462849)]
SETTINGS = ("mix", "serve", "p_only", "copy")


def mask_inputs(setting, T, V, gen, dev):
    """logits [T, V] f32, top_k [T] int32, top_p [T] f32 of one setting."""
    import torch
    logits = torch.randn((T, V), generator=gen, device=dev) * 3.0
    if setting == "mix":
        logits[2, :8] = logits[2].max() + 1.0  # 8 tied values, top_k 5
        if T == 72:
            ks = torch.tensor([0, 1, 5, 40, 50, V, V + 7, 8]).repeat(T // 8)
            ps = torch.tensor([1.0, 0.9, 0.5, 0.25, 1e-3, 0.95, 1.0, 0.999]
                              ).repeat_interleave(T // 8)
        else:
            ks = torch.tensor([0, 50, 5, 1, V, 0, 40, 50] * T)[:T]
            ps = torch.tensor([0.9, 1.0, 0.95, 0.5, 0.999, 1e-3, 0.25, 0.9]
                              * T)[:T]
    else:
        k, p = {"serve": (50, 0.9), "p_only": (0, 0.9),
                "copy": (0, 1.0)}[setting]
        ks, ps = torch.full((T,), k), torch.full((T,), p)
    return (logits, ks.to(dev, torch.int32).contiguous(),
            ps.to(dev, torch.float32).contiguous())


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    from repro_torch.kernels.sampling.ops import topk_topp_mask
    from repro_torch.kernels.sampling.ref import topk_topp_mask_ref
    if not torch.cuda.is_available():
        sys.exit("time_mask: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"root": args.root, "device": torch.cuda.get_device_name(0),
           "card": card(), "us": {}}
    for T, V in SHAPES:
        row = out["us"][f"{T}x{V}"] = {}
        for setting in SETTINGS:
            x, ks, ps = mask_inputs(setting, T, V, gen, dev)
            if not torch.equal(topk_topp_mask(x, ks, ps),
                               topk_topp_mask_ref(x, ks, ps)):
                sys.exit(f"time_mask: {setting} at {T}x{V} differs from the "
                         "plain version")
            row[setting] = {
                "kernel": device_us(lambda: topk_topp_mask(x, ks, ps)),
                "plain": device_us(lambda: topk_topp_mask_ref(x, ks, ps),
                                   calls=5, replays=5),
                "sort": device_us(lambda: torch.sort(x, dim=-1,
                                                     descending=True),
                                  calls=5, replays=5)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
