"""The least time the card could spend on the device work of the
window's jobs, over the summed time of every CUDA kernel in the traced
window: the least time is the bytes the work needs (``benchmark/work/``,
counted from the inputs) over the card's published bandwidth; no
operation count bounds this integer work."""


def read(run):
    if run.trace is None or not run.trace["kernel_s"] or not run.least_s:
        return None
    return 100.0 * run.least_s / run.trace["kernel_s"]
