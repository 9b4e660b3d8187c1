"""Milliseconds the harness waited on ``Polisher.polish``'s iterator for
each Mbp of the window's jobs (harness spans around each wait): the
Polisher layer's device passes and host repair, as the caller sees them."""


def read(run):
    if not run.bases:
        return None
    return 1e3 * run.span_s("wait") / (run.bases / 1e6)
