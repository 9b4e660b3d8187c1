"""Share of the window the harness spent in ``writers.write_contig``, the
CLI-and-I/O layer's rendering of the three outputs (harness spans)."""


def read(run):
    if not run.bases:
        return None
    return 100.0 * run.span_s("render") / run.window_s
