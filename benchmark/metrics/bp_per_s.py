"""Bases of draft or reference that the window's jobs took through the
engine to rendered outputs, over the window's time (host clock)."""


def read(run):
    if not run.bases:
        return None
    return run.bases / run.window_s
