"""Host milliseconds of the native repair per Mbp of reference: the self
time of the program's ``engine.repair`` spans (each native call, in the
thread that runs it; a name's time is the union over threads) over
``engine.bases``, in the traced window (``benchmark/program_trace.py``)."""

from benchmark.program_trace import program_keys


def read(run):
    spans, counters = program_keys(run)
    if spans is None or not counters.get("engine.bases") or "engine.repair" not in spans:
        return None
    return spans["engine.repair"] * 1e3 / (counters["engine.bases"] / 1e6)
