"""control_ms.<cell>: the mean wall time of a loop iteration of
VirtualCluster.serve outside engine.step (publishing the snapshot through
the head agent, the control plane's pump), over the untraced iterations
of the window."""


def read(run):
    v = [s for s, traced in run.control_s if not traced]
    return 1e3 * sum(v) / len(v) if v else None
