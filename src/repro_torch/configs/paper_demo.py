"""paper-demo — the paper's own experiment, transcribed.

Yu & Huang ran a 3-node virtual cluster (1 head + 2 compute containers on
Dell M620 blades, 10GbE) and a 16-rank MPI job (Fig. 8). This config captures
that scenario for the faithful-reproduction tests and benchmarks: a 3-node
VirtualCluster running a 16-domain SPMD job, plus a tiny LM standing in for
"the application" so the elastic runtime has real state to reshard.
"""
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class PaperClusterSpec:
    n_head_nodes: int = 1
    n_compute_nodes: int = 2
    mpi_ranks: int = 16  # the paper's 16-domain MPI job
    interconnect_gbps: float = 10.0  # 10GbE in Table I
    consul_ttl_s: float = 1.0  # health-check TTL (sim time)


CLUSTER = PaperClusterSpec()

# A ~100M-param LM used by the end-to-end examples (examples/quickstart.py):
# the modern analogue of the paper's MPI application.
CONFIG = ModelConfig(
    name="paper-demo-110m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    head_dim=64,
    block_pattern=("attn",),
    source="paper §IV scaled to a ~100M LM",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="paper-demo-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        block_pattern=("attn",),
    )
