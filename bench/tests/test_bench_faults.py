"""`correct` comes out false when the timed path is broken underneath:
the run is driven whole (the look for a card skipped, the CPU at smoke
size) with a fault planted in the engine before the window. Faults a
serving cell can have: a token altered where it is produced, and a step
that returns its state unchanged (the KV writes of every step dropped).
The training faults (half a batch, a mean over the rest) and the
exchange between chips have no place in a one-card serving cell."""
import time

import pytest
import torch

from bench import harness
from bench.tests import smoke

CELLS = smoke.CELLS


def alter_token(engine):
    """One decode row's token a step changed, a different slot's each step
    (so every request meets the fault)."""
    decode = engine.pool.decode
    n = [0]

    def bad(*a, **k):
        nxt = decode(*a, **k).clone()
        row = n[0] % engine.pool.num_slots
        nxt[row] = (nxt[row] + 1) % 512
        n[0] += 1
        return nxt
    engine.pool.decode = bad


def state_unchanged(engine):
    pool = engine.pool
    decode = pool.decode

    def bad(*a, **k):
        saved = [t.clone() for t in _leaves(pool.caches)]
        nxt = decode(*a, **k)
        for t, s in zip(_leaves(pool.caches), saved):
            t.copy_(s)
        return nxt
    pool.decode = bad


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [alter_token, state_unchanged])
def test_fault_makes_the_run_incorrect(cell, fault):
    out = harness.run(smoke.cell(cell), 2**31 + 3, 1.5, False,
                      torch.device("cpu"), time.monotonic(),
                      hooks={"engine": fault})
    assert not out["correct"], out["check"]
    assert out["check"]["gap"]["value"] > out["check"]["gap"]["limit"]
