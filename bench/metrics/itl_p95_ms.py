"""itl_p95_ms: the 95th percentile (nearest rank) of every gap between
two consecutive tokens of every request of the window, on the host."""
from bench import arith


def read(run):
    v = [(b - a) * 1e3 for s in run.stamps for a, b in zip(s, s[1:])]
    if not v:
        return None
    p, beyond = arith.nearest_rank(v, 95)
    return p if beyond >= 10 else None
