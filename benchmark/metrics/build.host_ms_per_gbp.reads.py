"""Host milliseconds of the filter build per Gbp of reads: the self time of
the program's ``build.*`` spans (the histogram pass and its readback, the
count and insert passes, the filter's download; the reader and the
uploads are their children, not counted) over ``io.read_bases``, in the
traced window (``benchmark/program_trace.py``)."""

from benchmark.program_trace import program_keys


def read(run):
    spans, counters = program_keys(run)
    if spans is None or not counters.get("io.read_bases"):
        return None
    build = sum(s for n, s in spans.items() if n.startswith("build."))
    return build * 1e3 / (counters["io.read_bases"] / 1e9)
