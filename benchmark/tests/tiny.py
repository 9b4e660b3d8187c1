"""Cells cut to a size a CPU test run holds: the same kinds, the same
code, a few tens of kbp and a filter of some hundred KiB at the cell's
fill.  The human configuration's cells are not in BENCHMARK.json (see
PERF.md) but their files and code paths stay tested."""

from __future__ import annotations

from benchmark import harness

CELLS = {  # cell: (configuration, traffic, end-to-end metrics)
    "human_k55.snv": ("human_k55", "snv", ["bp_per_s", "setup_s"]),
    "ecoli_k25.polish": ("ecoli_k25", "polish", ["bp_per_s", "setup_s"]),
    "human_k55.polish": ("human_k55", "polish_contigs", ["bp_per_s", "setup_s"]),
    "ecoli_k25.reads": ("ecoli_k25", "reads", ["read_bp_per_s", "setup_s"]),
}
ENGINE = ("human_k55.snv", "ecoli_k25.polish", "human_k55.polish")


def spec(cell: str) -> dict:
    config, traffic_name, e2e = CELLS[cell]
    per_layer = ["io.render_share_pct", "engine.wait_ms_per_mbp", "kernels.roofline_pct",
                 "device.idle_pct"] if cell in ENGINE else ["kernels.roofline_pct.reads",
                                                            "device.idle_pct.reads"]
    units = {"bp_per_s": "bp/s", "read_bp_per_s": "bp/s", "setup_s": "s"}
    metrics = {"end_to_end": [{"name": n, "unit": units[n]} for n in e2e],
               "per_layer": [{"name": n, "unit": "%"} for n in per_layer]}
    s = harness.spec_of(config, traffic_name, metrics)
    cfg, traffic = s["config"], s["traffic"]
    traffic["pool"] = 2
    if traffic["kind"] == "reads":
        cfg.update(contig_bp=[40000])
        traffic["reads"]["kmers"] = 40000 * 30
        traffic["check"].update(stretches=3, width=10000)
    elif traffic["input"] in ("reference", "sample_draft"):
        cfg.update(contig_bp=[40000], filter_bytes=1 << 18, filter_kmers=150000,
                   n_run={"at": 0.4, "bp": 300})
        traffic["check"].update(stretches=4, width=3000)
        if "contigs" in traffic:
            traffic["contigs"] = {"count": 5, "sigma": 1.0, "short_bp": [60]}
    else:
        cfg.update(contig_bp=[50000, 30000, 60], filter_bytes=1 << 17)
        traffic["check"].update(stretches=4, width=15000)
    return s


ALL = tuple(CELLS)
