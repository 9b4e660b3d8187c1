"""Read bases of the window's ``polish --reads`` jobs (reads to filter to
polished outputs), over the window's time (host clock)."""


def read(run):
    if not run.bases:
        return None
    return run.bases / run.window_s
