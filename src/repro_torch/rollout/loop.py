"""RolloutLoop — generate -> score -> train rounds on one VirtualCluster
(port of the JAX package's rollout/loop.py).

The loop alternates phases on the cluster the serving fleet runs on.
During a generate phase the engine's snapshots reach the registry and the
autoscaler grows the fleet into the rollout burst; during a train phase
the serve queue is empty, the loop publishes its own phase metrics
(rollout_tokens, reward_mean, pairs_per_round, train_loss) under the
"rollout" source, and the same policy reads them beside the idle serve
signals: serve and train arbitrate through one metrics plane.

After each train phase the new params go into every replica
(engine.set_params), so round r + 1 samples from round r's policy.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.rollout.engine import RolloutEngine
from repro_torch.rollout.preference import PreferenceTrainer, build_pairs
from repro_torch.rollout.scorer import Scorer

# the four phase metrics the autoscaler aggregates (core/autoscaler.py):
# token and pair counters sum across sources, reward and loss average
PHASE_METRICS = ("rollout_tokens", "reward_mean", "pairs_per_round",
                 "train_loss")


class RolloutLoop:
    def __init__(self, cluster, rollout_engine: RolloutEngine,
                 scorer: Scorer, trainer: PreferenceTrainer, *,
                 prompts: Sequence[np.ndarray], dt: float = 0.05,
                 turns: int = 1, train_steps: int = 2,
                 train_phase_s: float = 0.2, on_step=None):
        self.cluster = cluster
        self.rollouts = rollout_engine
        self.scorer = scorer
        self.trainer = trainer
        self.prompts = list(prompts)
        self.dt = dt
        self.turns = turns
        self.train_steps = train_steps
        self.train_phase_s = train_phase_s
        self.on_step = on_step
        self.history: List[Dict[str, float]] = []
        self.last_rollouts: List = []  # the last round's, by rid

    @property
    def engine(self):
        return self.rollouts.engine

    def _publish(self, phase: Dict[str, float]) -> None:
        """Push the phase metrics into the registry as the "rollout"
        source and pump the control plane through the simulated train
        time, then reconcile the fleet to the compute-node count."""
        head = self.cluster.sim.nodes[self.cluster.head_id].agent
        head.report_serving(phase, source="rollout")
        self.cluster.pump(dt=self.train_phase_s, autoscale=True)
        reconcile = getattr(self.engine, "reconcile", None)
        if reconcile is not None:
            n = max(len(self.cluster.current_view().compute), 1)
            reconcile(n)

    def round(self) -> Dict[str, float]:
        """One generate -> score -> train round; its phase metrics (also
        appended to history and published to the registry)."""
        ros = self.rollouts.generate(self.prompts, cluster=self.cluster,
                                     dt=self.dt, turns=self.turns,
                                     on_step=self.on_step)
        self.last_rollouts = ros
        rewards = self.scorer.score(ros)
        for r, w in zip(ros, rewards):
            r.reward = float(w)
        pairs = build_pairs(ros)
        # pad to the largest pair count and context so every round's
        # batch has one shape
        pad_len = max(len(r.prompt) + len(r.tokens) for r in ros)
        tm = self.trainer.train(pairs, steps=self.train_steps,
                                pad_pairs=len(self.prompts) * self.turns,
                                pad_len=pad_len)
        if pairs:
            self.engine.set_params(self.trainer.params)
        phase = {
            "rollout_tokens": float(self.rollouts.last_tokens),
            "reward_mean": float(np.mean(rewards)) if rewards else 0.0,
            "pairs_per_round": tm["pairs_per_round"],
            "train_loss": tm["train_loss"],
        }
        self._publish(phase)
        self.history.append({**phase,
                             "train_loss_first": tm["train_loss_first"],
                             "dpo_margin": tm["dpo_margin"],
                             "n_rollouts": float(len(ros))})
        return phase

    def run(self, rounds: int = 2) -> List[Dict[str, float]]:
        for _ in range(rounds):
            self.round()
        return self.history[-rounds:]

    def retire(self) -> None:
        """Tombstone the "rollout" metric source (the loop is done), so
        its last snapshot stops weighing on the fleet's aggregates."""
        head = self.cluster.sim.nodes[self.cluster.head_id].agent
        head.retire_source("rollout")
