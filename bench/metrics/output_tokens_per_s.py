"""output_tokens_per_s: every output token that reached the host in the
window, over the window (its open to the end of the last step)."""


def read(run):
    span = run.t_stop - run.t_open
    if span <= 0:
        return None
    return sum(1 for s in run.stamps for t in s if t > run.t_open) / span
