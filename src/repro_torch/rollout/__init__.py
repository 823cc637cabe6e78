"""Rollout subsystem (port of the JAX package's rollout/): the serving
fleet as a reproducible generation engine for post-training.

RolloutEngine (rollout/engine.py) fans a prompt set out over the
continuous-batching serving plane as seeded, bit-reproducible rollouts;
Scorers (rollout/scorer.py) assign per-completion rewards;
PreferenceTrainer (rollout/preference.py) turns scored rollouts into DPO
updates through AdamW in train mode; RolloutLoop (rollout/loop.py)
alternates the phases on one VirtualCluster and swaps each round's
trained weights into the fleet. Generation runs the serving kernels;
training runs train mode, which launches none of them.
"""
from repro_torch.rollout.engine import (  # noqa: F401
    Rollout,
    RolloutEngine,
    rollout_signature,
)
from repro_torch.rollout.loop import PHASE_METRICS, RolloutLoop  # noqa: F401
from repro_torch.rollout.preference import (  # noqa: F401
    PreferenceTrainer,
    build_pairs,
    completion_logprobs,
    pack_pair_batch,
    pack_sequences,
)
from repro_torch.rollout.scorer import (  # noqa: F401
    KeywordScorer,
    LengthScorer,
    LogprobScorer,
    Scorer,
    make_scorer,
)
