"""The measured step against the analytic count on every cell of
configs.cells() over both production meshes (64 cases): the step the
port executes, run once for rank 0 on the meta device inside a fake
process group of 256 or 512 ranks (launch/step_analysis.py
measure_step), against launch/roofline.py count_step under the cell's
default plan (int8 moments past 1e11 parameters, as analyze() takes
them). The measured flops plus StepCount.unmatmul (the WKV decode
readout, a product without a matmul op) equal the analytic flops, and
the collective bytes are equal type by type and (mesh axis, type) by
(mesh axis, type), exactly. The measurement's own figures are held
together: the rank's arguments are the bytes of its inputs, its peak
temporary storage and its traffic are positive.

A train cell's measurement runs a million tensor ops or more on the
meta device (every ROW_TILE-row tile of every product, forward,
recompute and backward), seconds to tens of seconds each, so the 64
cases are split into GROUPS, one test file each
(tests/test_torch_step_cells_<n>.py), each well under a minute alone.
"""
import pytest
import torch

from repro_torch.configs import cells, get_config, get_shape
from repro_torch.configs.base import default_plan
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import count_step
from repro_torch.launch.step_analysis import measure_step
from repro_torch.models.env import Env
from repro_torch.optim.adamw import AdamWConfig

MESHES = ("single", "multi")
ALL = [(a, s, m) for m in MESHES for a, s, _ in cells()]


def _train(mesh, *archs):
    return [(a, "train_4k", mesh) for a in archs]


# balanced by the cases' measured time alone (one thread): a train cell
# 7-38 s, the prefill, decode and long_500k cells 0.1-6 s
GROUPS = {
    1: _train("single", "yi-9b", "qwen2-vl-7b"),
    2: _train("single", "grok-1-314b", "whisper-small"),
    3: _train("single", "qwen3-32b", "qwen2-1.5b"),
    4: _train("single", "rwkv6-1.6b") + _train("multi", "qwen2-1.5b"),
    5: _train("single", "recurrentgemma-9b", "granite-3-8b"),
    6: _train("single", "llama4-scout-17b-a16e")
    + _train("multi", "yi-9b", "whisper-small"),
    7: _train("multi", "rwkv6-1.6b", "llama4-scout-17b-a16e"),
    8: _train("multi", "qwen3-32b", "grok-1-314b"),
    9: _train("multi", "recurrentgemma-9b", "granite-3-8b", "qwen2-vl-7b"),
    10: [c for c in ALL if c[1] != "train_4k" and c[2] == "single"],
    11: [c for c in ALL if c[1] != "train_4k" and c[2] == "multi"],
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a module runs, the caller's count restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nonzero(d):
    return {k: v for k, v in d.items() if v}


def check(arch: str, shape: str, mesh: str):
    cfg, sh = get_config(arch), get_shape(shape)
    env = Env(plan=default_plan(cfg, sh),
              mesh=make_production_mesh(multi_pod=mesh == "multi",
                                        abstract=True))
    opt = AdamWConfig(state_dtype="int8" if cfg.param_count() > 1e11
                      else "fp32")
    got = measure_step(cfg, sh, env, opt, units=False)
    want = count_step(cfg, sh, env, opt)
    assert got.flops + want.unmatmul == want.flops, (got.flops, want.flops,
                                                     want.unmatmul)
    assert (want.unmatmul > 0) == (arch == "rwkv6-1.6b"
                                   and sh.kind == "decode")
    assert nonzero(got.coll.by_type) == nonzero(want.coll.by_type)
    assert nonzero(got.coll.by_axis) == nonzero(want.coll.by_axis)
    assert got.args_bytes > 0 and got.temp_bytes > 0
    assert got.bytes_accessed > got.args_bytes
    assert got.units == []
