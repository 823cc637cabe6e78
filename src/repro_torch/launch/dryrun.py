"""Dry run over the production meshes: the analytic roofline of every
(arch x shape) cell on the H100's rates (port of the JAX package's
launch/dryrun.py).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

The meshes are shape-only (launch/mesh.py make_production_mesh(abstract=
True): 16 x 16 and 2 x 16 x 16 devices), so the run needs no rank and no
card: each cell's terms come from launch/roofline.py analyze_cell and
launch/memory_model.py (where the JAX package lowers and compiles the
step, `analysis_s` is the analysis's own time). One `OK` line a cell
(compute, memory and collective ms, the dominant term, the fit in the
card's 80 GB) after a line naming the fabric each mesh axis rides, a
`SKIP` line for a long-context cell of a full-attention
arch; exit 1 on any failure. Reports land in
reports/dryrun_torch/<mesh>/<arch>__<shape>.json.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import H100, analyze_cell, axis_fabric

MESHES = {"single": ("single_pod_16x16", False),
          "multi": ("multi_pod_2x16x16", True)}


def run_cell(arch: str, shape: str, mesh, mesh_tag: str, outdir: str,
             capacity_bytes=None) -> dict:
    t0 = time.perf_counter()
    rep = analyze_cell(arch, shape, mesh, capacity_bytes=capacity_bytes)
    rep["analysis_s"] = round(time.perf_counter() - t0, 3)
    os.makedirs(os.path.join(outdir, mesh_tag), exist_ok=True)
    path = os.path.join(outdir, mesh_tag, f"{arch}__{shape}.json")
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    return rep


def ok_line(mesh_tag: str, rep: dict) -> str:
    mem = rep["memory"]
    return (f"OK   {mesh_tag} {rep['arch']:24s} {rep['shape']:12s} "
            f"compute={rep['compute_s'] * 1e3:10.2f}ms "
            f"mem={rep['memory_s'] * 1e3:9.2f}ms "
            f"coll={rep['collective_s'] * 1e3:10.2f}ms "
            f"dom={rep['dominant']:10s} fit={mem['fits_device']} "
            f"t={rep['analysis_s']:.2f}s")


def run(todo, mesh_names, outdir: str, capacity_bytes=None, say=print):
    """Analyze each (arch, shape) of `todo` on each named mesh. Returns
    ({mesh_tag: [reports]}, [failures])."""
    reports, failures = {}, []
    for name in mesh_names:
        mesh_tag, multi = MESHES[name]
        mesh = make_production_mesh(multi_pod=multi, abstract=True)
        fabric = axis_fabric(dict(zip(mesh.mesh_dim_names, mesh.shape)))
        say(f"mesh {mesh_tag}: " + ", ".join(
            f"{a} over {f}" for a, f in fabric.items()))
        reports[mesh_tag] = []
        for arch, shape in todo:
            if SHAPES[shape].long_context and not get_config(
                    arch).sub_quadratic:
                say(f"SKIP {mesh_tag} {arch} {shape}: full attention")
                continue
            try:
                rep = run_cell(arch, shape, mesh, mesh_tag, outdir,
                               capacity_bytes)
                reports[mesh_tag].append(rep)
                say(ok_line(mesh_tag, rep))
            except Exception as e:  # noqa: BLE001 - report every cell
                failures.append((mesh_tag, arch, shape, repr(e)))
                say(f"FAIL {mesh_tag} {arch} {shape}: {e!r}")
                traceback.print_exc()
    return reports, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s) for a, s, tag in cells() if tag == "run"]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    print(f"rates: {H100['name']} at {H100['power_limit_w']} W: "
          f"{H100['bf16_flops'] / 1e12:g} TFLOP/s bf16, "
          f"{H100['hbm_bytes_per_s'] / 1e12:g} TB/s HBM, "
          f"{H100['hbm_bytes'] / 1e9:g} GB, NVLink "
          f"{H100['nvlink_bytes_per_s'] / 1e9:g} GB/s a direction in a "
          f"node of {H100['node_gpus']}, "
          f"{H100['network_bytes_per_s'] / 1e9:g} GB/s between nodes; "
          f"{H100['source']}")
    _, failures = run(todo, names, args.out)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", *f)
        return 1
    print("\nALL CELLS PASSED")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
