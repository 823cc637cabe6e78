"""Device time of the paged-decode kernels (#1, and #3 where named) at the
shapes the serving path gives them, for the tree at --root (default: this
checkout), so that two trees can be timed one after the other on one card:

  python3 tools/time_paged_decode.py [--root DIR] [--spans 256,320,384,512]

Cases, all at paper-demo-110m's attention (Hq 12, Hkv 4, hd 64, bs 16):
  phase2         chip_smoke.py phase 2's step: 8 decode rows at depths
                 64..95, a 64-row prefill lane, a masked, a depth-0 and a
                 full-table row over 96-token tables;
  classic        8 decode rows at depths 256..287 over 288-token tables (18
                 blocks): classic admission and the slot pool at prompt
                 256, gen 32 (chip_smoke.py phases 9 and 10); #1 and #3;
  classic_short  the same tables with the rows at depths 224..255;
  baseline       16 rows at depths 256..287 over the one-shot baseline's
                 contiguous cache, read as one block of S = 288 tokens;
  long           8 rows at depths 1984..2047 over 2048-token tables.

Each case is checked against the plain version (max abs error) and timed
as a CUDA graph of 20 calls replayed 20 times (CUDA events, us a call).
Where the tree's paged-decode ops have a SPAN, every case is timed at
each span given. Prints one JSON object.
"""
import argparse
import json
import sys
from pathlib import Path


def device_us(fn, calls=20, replays=20):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays / calls * 1e3


def case_inputs(gen, dev, lens, bs, MB):
    """bf16 q and pools for rows of the given last positions, each row on
    its own blocks (a contiguous cache when MB is 1: block b is row b)."""
    import torch
    Hq, Hkv, hd = 12, 4, 64
    B = len(lens)
    NB = 1 + B * MB
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, kp, vp = mk(B, Hq, hd), mk(NB, Hkv, bs, hd), mk(NB, Hkv, bs, hd)
    perm = torch.randperm(NB - 1, generator=gen, device=dev) + 1
    tables = perm[:B * MB].view(B, MB).int().contiguous()
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lengths


def phase2_inputs(gen, dev):
    import torch
    q, kp, vp, tables, lengths = case_inputs(
        gen, dev, [64 + (b * 5) % 32 for b in range(8)] + [0] * 67, 16, 6)
    tables[8:72] = tables[0]  # the lane's rows read the same blocks
    lengths[8:72] = torch.arange(64, dtype=torch.int32, device=dev)
    lengths[72] = -1
    lengths[74] = 6 * 16 - 1
    return q, kp, vp, tables, lengths


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--spans", default="256,320,384,512")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    from repro_torch.kernels.paged_decode import ops
    from repro_torch.kernels.paged_decode.ref import (paged_decode_quant_ref,
                                                      paged_decode_ref)
    if not torch.cuda.is_available():
        sys.exit("time_paged_decode: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    deep = [256 + 4 * b for b in range(8)]
    cases = {
        "phase2": phase2_inputs(gen, dev),
        "classic": case_inputs(gen, dev, deep, 16, 18),
        "classic_short": case_inputs(gen, dev, [d - 32 for d in deep], 16,
                                     18),
        "baseline": case_inputs(gen, dev, [256 + 2 * b for b in range(16)],
                                288, 1),
        "long": case_inputs(gen, dev, [1984 + 8 * b for b in range(8)], 16,
                            128),
    }
    q, kp, vp, tables, lengths = cases["classic"]
    kq, ks = ops.quantize_kv(kp)
    vq, vs = ops.quantize_kv(vp)
    quant = (q, kq, vq, ks, vs, tables, lengths)

    def measure():
        row = {}
        for name, pin in cases.items():
            err = float((ops.paged_flash_decode(*pin)
                         - paged_decode_ref(*pin)).abs().max())
            row[name] = {"us": device_us(lambda: ops.paged_flash_decode(*pin)),
                         "max_abs_err": err}
        err = float((ops.paged_flash_decode_quant(*quant)
                     - paged_decode_quant_ref(*quant)).abs().max())
        row["classic_int8"] = {
            "us": device_us(lambda: ops.paged_flash_decode_quant(*quant)),
            "max_abs_err": err}
        return row

    out = {"root": args.root, "device": torch.cuda.get_device_name(0)}
    if hasattr(ops, "SPAN"):
        chosen = ops.SPAN
        out["span"] = chosen
        out["by_span"] = {}
        for span in (int(s) for s in args.spans.split(",")):
            ops.SPAN = span
            out["by_span"][span] = measure()
        ops.SPAN = chosen
    else:
        out["default"] = measure()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
