"""The control of `correct` at a size a test run holds: the reference
with its products in float8 e4m3, on the same served tokens, comes out
not correct under the committed limits where the program comes out
correct (bench/control.py reads it on the card at the cells' own
sizes). The smoke widths run at the configuration's own depth, since
float8's error grows with the layers it passes through, and every
served request is compared."""
import time

import pytest
import torch

from bench import harness, spec, traffic
from bench.tests import smoke


@pytest.mark.parametrize("cell", smoke.CELLS)
def test_control_is_not_correct_under_the_committed_limits(cell):
    committed = spec.cell(smoke.entries(), cell)
    c = smoke.cell(cell)
    c.config["num_hidden_layers"] = committed.config["num_hidden_layers"]
    dev = torch.device("cpu")
    for seed in (4, 5):
        items = traffic.generate(c.mix, c.config["vocab_size"], seed, 1.5)
        c.mix["check"]["requests"] = len(items)
        st = harness.setup(c, seed, dev)
        rec = harness.window(st, c, items, 1.5, False, time.monotonic())
        harness.release(st)
        prog, ctl = harness.judge(c, rec, st.tree, seed, dev, control=True)
        assert ctl["gap"] == {"value": ctl["gap"]["value"],
                              "limit": committed.limits["gap"]["limit"]}
        assert harness.correct(prog), prog
        assert not harness.correct(ctl), ctl
        assert prog["positions"]["value"] >= 10
