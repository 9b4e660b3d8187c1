"""SNV candidates the card found per Mbp of reference: the program's
``engine.snv_candidates`` counter (the device's candidate heads, once a
contig) over its ``engine.bases``, in the traced window
(``benchmark/program_trace.py``)."""

from benchmark.program_trace import program_keys


def read(run):
    _, counters = program_keys(run)
    if counters is None or not counters.get("engine.bases") or "engine.snv_candidates" not in counters:
        return None
    return counters["engine.snv_candidates"] / (counters["engine.bases"] / 1e6)
