"""The least time the card could spend on the device work of the
window's polish --reads jobs (``benchmark/work/read_pipeline.py``: the
reads, the counters and filter sectors of the build, the draft and the
filter sectors of the engine pass) over the summed time of every CUDA
kernel in the traced window; bytes over the published bandwidth."""


def read(run):
    if run.trace is None or not run.trace["kernel_s"] or not run.least_s:
        return None
    return 100.0 * run.least_s / run.trace["kernel_s"]
