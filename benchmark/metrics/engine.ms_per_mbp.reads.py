"""Host milliseconds of the Polisher per Mbp of draft: the self time of the
program's ``engine.*`` spans (the filter's upload, each contig, the gate
pass and the waits for its chunks, the repair in its threads, the
fallback) over ``engine.bases``, in the traced window
(``benchmark/program_trace.py``)."""

from benchmark.program_trace import program_keys


def read(run):
    spans, counters = program_keys(run)
    if spans is None or not counters.get("engine.bases"):
        return None
    engine = sum(s for n, s in spans.items() if n.startswith("engine."))
    return engine * 1e3 / (counters["engine.bases"] / 1e6)
