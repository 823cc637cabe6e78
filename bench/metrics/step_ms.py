"""step_ms.<cell>: the mean wall time of ServingEngine.step (admission,
the fused step, retirement) over the untraced steps of the window that
had work (a token or a prompt position)."""


def read(run):
    v = [it.t1 - it.t0 for it in run.iterations
         if it.worked and not it.traced]
    return 1e3 * sum(v) / len(v) if v else None
