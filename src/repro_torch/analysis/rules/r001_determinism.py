"""R001 — determinism: no wall clock, no unseeded global RNG, no
unordered-set iteration in the simulated data plane (port of the JAX
package's rule, with torch's global generator added).

The serving/rollout/core sim paths promise bit-reproducible behavior
(seeded rollouts are a pure function of (params, prompt, seed); drains
and preemptions replay bit-identically). These silently break it:

  * wall-clock reads (time.time / monotonic / perf_counter, datetime.now,
    time.sleep): sim paths take a core.clock.Clock, the one injectable
    time source (launch/ and benchmarks/ measure real wall time on
    purpose and are out of scope);
  * module-level RNG (random.*, numpy.random.* global state);
  * torch's global generator: torch.rand / randn / randint / randperm,
    their *_like forms, normal, bernoulli, multinomial and poisson with
    no `generator=`; torch.manual_seed, torch.seed, torch.random.* and
    torch.cuda.manual_seed(_all), which reseed process-wide state; the
    in-place samplers (.uniform_, .normal_, .random_, .bernoulli_,
    .exponential_, .geometric_, .cauchy_, .log_normal_) with no
    `generator=`. The port draws per request from keys
    (repro_torch/random.py) and initializes from a seeded
    torch.Generator;
  * iterating a set: Python sets hash-order their elements, and string
    hashing is salted per process, so `for x in some_set` visits in a
    different order run to run. Wrap in sorted(...). (Dicts are
    insertion-ordered and are NOT flagged.)
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import Corpus, Finding, Rule, SourceFile
from repro_torch.analysis.rules import common

WALL_CLOCK = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.sleep",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

# numpy.random module-level (global state) calls that stay reproducible /
# are explicitly seeded constructors: everything else under numpy.random
# is the legacy global generator
NP_RANDOM_OK = frozenset({"default_rng", "Generator", "SeedSequence",
                          "PCG64", "Philox"})

# torch samplers that draw from the global generator unless given one
TORCH_SAMPLERS = frozenset(f"torch.{n}" for n in (
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson"))
# calls that (re)seed torch's process-wide generators
TORCH_RESEED = frozenset({"torch.manual_seed", "torch.seed",
                          "torch.cuda.manual_seed",
                          "torch.cuda.manual_seed_all"})
# in-place tensor samplers (x.uniform_(...), torch.nn.init.normal_(x))
INPLACE_SAMPLERS = frozenset({"uniform_", "normal_", "random_", "bernoulli_",
                              "exponential_", "geometric_", "cauchy_",
                              "log_normal_"})

WALL_ALLOWED_DIRS = ("launch", "benchmarks", "examples", "tools", "tests")


class DeterminismRule(Rule):
    id = "R001"
    name = "determinism"
    doc = ("wall-clock reads, unseeded module-level or torch-global RNG, "
           "and unordered set iteration inside serve/rollout/core sim "
           "paths")

    def check(self, corpus: Corpus) -> Iterator[Finding]:
        for sf in corpus:
            if not sf.in_dirs(common.SIM_SCOPES):
                continue
            if sf.in_dirs(WALL_ALLOWED_DIRS):
                continue
            yield from self._check_file(sf)

    def _check_file(self, sf: SourceFile) -> Iterator[Finding]:
        yield from self._check_calls(sf, sf.imports)
        yield from self._check_set_iteration(sf)

    def _check_calls(self, sf: SourceFile,
                     imports) -> Iterator[Finding]:
        for node in sf.nodes:
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in INPLACE_SAMPLERS \
                    and not common.has_kwarg(node, "generator"):
                yield self.finding(
                    sf, node,
                    f"in-place sampler .{node.func.attr}() with no "
                    "generator= draws from torch's global generator — "
                    "pass a seeded torch.Generator")
                continue
            dn = common.resolve_call(node, imports)
            if dn is None:
                continue
            if dn in WALL_CLOCK:
                yield self.finding(
                    sf, node,
                    f"wall-clock call {dn}() in a sim path — time must "
                    "come from an injected core.clock.Clock so tests and "
                    "replays are deterministic")
            elif dn.startswith("random.") and dn.count(".") == 1:
                yield self.finding(
                    sf, node,
                    f"module-level RNG {dn}() draws from unseeded global "
                    "state — use np.random.default_rng(seed), a seeded "
                    "torch.Generator or repro_torch.random's keys")
            elif dn.startswith("numpy.random.") \
                    and dn.split(".")[2] not in NP_RANDOM_OK:
                yield self.finding(
                    sf, node,
                    f"numpy global-state RNG {dn}() — construct a seeded "
                    "np.random.default_rng(seed) generator instead")
            elif dn in TORCH_SAMPLERS \
                    and not common.has_kwarg(node, "generator"):
                yield self.finding(
                    sf, node,
                    f"{dn}() with no generator= draws from torch's global "
                    "generator — pass a seeded torch.Generator (or draw "
                    "from repro_torch.random's per-request keys)")
            elif dn in TORCH_RESEED or dn.startswith("torch.random."):
                yield self.finding(
                    sf, node,
                    f"{dn}() touches torch's process-wide generator "
                    "state — every caller in the process shares it; "
                    "seed a torch.Generator and pass it as generator=")

    def _check_set_iteration(self, sf: SourceFile) -> Iterator[Finding]:
        # one module-wide binding pass: local names and self.X attributes
        # assigned set-like values anywhere (a name that is a set in ANY
        # scope is treated as a set in all: the conservative direction)
        local, attrs = common.collect_set_bindings(sf.nodes)
        for node in sf.nodes:
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters = [node.iter]
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                iters = [g.iter for g in node.generators]
            for it in iters:
                if common.is_setlike(it, local, attrs):
                    yield self.finding(
                        sf, node,
                        "iteration over an unordered set in a sim path — "
                        "set order is hash-salted per process; wrap the "
                        "iterable in sorted(...) to pin it")
