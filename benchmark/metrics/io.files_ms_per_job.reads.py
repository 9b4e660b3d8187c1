"""Host milliseconds a job spends on files other than the reads: the self
time of the program's ``io.save`` (the .hist and the filter written),
``io.load`` (the filter read back), ``io.draft`` (the draft's records) and
``io.render`` (the three outputs) spans, over the jobs of the traced
window (``benchmark/program_trace.py``)."""

from benchmark.program_trace import program_keys


def read(run):
    spans, _ = program_keys(run)
    if spans is None or not run.job_s:
        return None
    files = sum(spans.get(n, 0.0) for n in ("io.save", "io.load", "io.draft", "io.render"))
    return files * 1e3 / len(run.job_s)
