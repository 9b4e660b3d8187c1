"""Share of the card's idle time in the traced window that falls inside the
batch reader: the device-idle seconds whose covering program span (the
one that started last) is ``io.read``, over all device-idle seconds of
the window (``benchmark/program_trace.py``)."""


def read(run):
    t = run.trace or {}
    if "idle_by_span" not in t or not t.get("idle_s"):
        return None
    return 100.0 * t["idle_by_span"].get("io.read", 0.0) / t["idle_s"]
