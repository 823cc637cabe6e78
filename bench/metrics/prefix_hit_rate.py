"""prefix_hit_rate.<cell>: the share of the prompt positions probed at
admission in the window that the KV backend's prefix cache served
(BlockManager's prefix_hit_tokens / prefix_lookup_tokens, counted over
the window), in %."""


def read(run):
    a, b = run.counters["open"], run.counters["close"]
    looked = b["prefix_lookup_tokens"] - a["prefix_lookup_tokens"]
    if looked <= 0:
        return None
    return 100.0 * (b["prefix_hit_tokens"] - a["prefix_hit_tokens"]) / looked
