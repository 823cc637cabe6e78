"""device_idle.<cell>: the share of the traced steps' wall span in which
the profiler's timeline shows nothing running on the card, in %. The
profiler adds host time, so this is an upper bound."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0 or tl.n_device_events == 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
