"""ttft_p90_ms: the 90th percentile (nearest rank) over every request of
the window, from the time it was due to its first token on the host.
Nothing when a request got no token, or fewer than MIN_BEYOND lie beyond.

MIN_BEYOND is 8 and not 10: at the rag cell's fixed 1.6 requests/s, the
longest run (51 s) holds 82 requests, of which 8 lie beyond the p90."""
from bench import arith

MIN_BEYOND = 8


def read(run):
    if any(not s for s in run.stamps):
        return None
    v = [(s[0] - run.due(i)) * 1e3 for i, s in enumerate(run.stamps)]
    p, beyond = arith.nearest_rank(v, 90)
    return p if beyond >= MIN_BEYOND else None
