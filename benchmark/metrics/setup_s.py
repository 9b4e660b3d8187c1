"""Process start to the window's start (host clock): imports, the
kernels built or loaded from the build cache, the inputs made from the
seed, the filter uploaded, the cell's shapes warmed by one job."""


def read(run):
    return run.setup_s
