"""The repair's useful outcomes over its attempts: 100 times the records the
Polisher wrote (``engine.records``) over the gates the device handed the
repair (``engine.gates``), in the traced window
(``benchmark/program_trace.py``)."""

from benchmark.program_trace import program_keys


def read(run):
    _, counters = program_keys(run)
    if counters is None or not counters.get("engine.gates"):
        return None
    return 100.0 * counters.get("engine.records", 0) / counters["engine.gates"]
