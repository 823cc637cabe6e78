"""The port's engine serves the four dense attention archs and the two
MoE archs as the JAX package's engine does (CPU, smoke configs).

The same seeded Poisson trace (8 requests, prompt 16, gen 16, 4 slots)
through the port's ServingEngine and JAX's ServingEngine under the pallas
plan, on the same weights (the JAX package's, through the numpy bridge):
greedy tokens equal, through chunked-prefill lanes and through classic
admission (batch-1 prefill + insert), and over the int8 pool (--kv quant)
for one dense and one MoE arch.

For the MoE archs this is the only token-level oracle: capacity and drops
depend on which tokens one dispatch holds, so JAX's own engine does not
equal its one-shot baseline there (tests/test_torch_zoo.py pins that).
Equality with JAX's engine needs the port to dispatch exactly JAX's rows,
masked rows included and padding rows not; the MoE smoke traces drop
tokens through chunked lanes (asserted), so a wrong row set shows.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.configs.base import ParallelPlan
from repro.core.clock import ManualClock as JaxClock
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.serve import ServingEngine as JaxEngine
from repro.serve import request as jax_request
from repro.serve import run_to_completion as jax_run
from repro_torch import bridge
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.core.clock import ManualClock
from repro_torch.models import moe as M
from repro_torch.serve import ServingEngine, run_to_completion
from repro_torch.serve import request as torch_request

DENSE = ("yi-9b", "granite-3-8b", "qwen3-32b", "qwen2-1.5b")
MOE = ("grok-1-314b", "llama4-scout-17b-a16e")
PALLAS = ParallelPlan(fsdp=False, remat="full", attn_impl="pallas",
                      kv_cache="replicated")
# engine settings per case: chunked lanes (the default), classic
# admission, the int8 pool
MODES = {"chunked": {}, "classic": {"prefill_chunk": 0},
         "quant": {"kv": "quant"}}
CASES = ([(a, m) for a in DENSE + MOE for m in ("chunked", "classic")]
         + [("granite-3-8b", "quant"), ("llama4-scout-17b-a16e", "quant")])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's eager CPU ops at these sizes gain nothing from torch's
    intra-op pool, and under several test workers its spinning threads
    only take cores from the others: one thread while this module runs,
    the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _trace(mod, vocab):
    return mod.poisson_trace(8, 16.0, prompt_len=16, vocab_size=vocab,
                             gen_len=16, seed=0)


@pytest.mark.parametrize("arch,mode", CASES,
                         ids=[f"{a}-{m}" for a, m in CASES])
def test_greedy_tokens_equal_the_jax_engine(arch, mode):
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    jp = JMo.init_params(jax.random.PRNGKey(0), jcfg,
                         JEnv(mesh=None, plan=PALLAS))
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    ekw = dict(num_slots=4, prompt_len=16, max_gen=16, **MODES[mode])
    jout = jax_run(JaxEngine(jcfg, jp, clock=JaxClock(), plan=PALLAS, **ekw),
                   _trace(jax_request, jcfg.vocab_size), dt=0.05)
    eng = ServingEngine(cfg, tp, clock=ManualClock(), device="cpu", **ekw)
    assert eng.kv == ("quant" if mode == "quant" else "paged")
    assert bool(eng.prefill_chunk) == (mode != "classic")
    with M.dispatch_stats() as stats:
        out = run_to_completion(eng, _trace(torch_request, cfg.vocab_size),
                                dt=0.05)
    assert sorted(out) == list(range(8))
    assert out == jout
    if arch in MOE:
        # every layer of every step and prefill dispatched; the steps of
        # chunked lanes overflow capacity (classic admission's 16-token
        # prefills and 4-row steps do not always)
        assert len(stats) % cfg.n_layers == 0 and stats
        if mode != "classic":
            assert sum(r["dropped"] for r in stats) > 0
    else:
        assert not stats
