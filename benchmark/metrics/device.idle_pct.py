"""Share of the traced window with no kernel, copy or set running on the
card: one minus the union of the profiler's device intervals over the
window."""


def read(run):
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
