"""Host milliseconds of the batch reader per Gbp it read: the self time of
the program's ``io.read`` spans (inflating and parsing the read files,
joining the records, cutting the pieces) over its ``io.read_bases``, in
the traced window (``benchmark/program_trace.py``)."""

from benchmark.program_trace import program_keys


def read(run):
    spans, counters = program_keys(run)
    if spans is None or not counters.get("io.read_bases"):
        return None
    return spans.get("io.read", 0.0) * 1e3 / (counters["io.read_bases"] / 1e9)
