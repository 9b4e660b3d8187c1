"""The control of a cell's correctness check: the plain reference put in
the program's place with one guarantee the configuration states broken,
each k-mer probed by fewer of the three bits its filter sets (the cell's
``check.control_bits``: two, or one where the outputs cannot show two),
compared with the reference on the check's stretches, at the cell's own
size:

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

It prints one JSON line a seed with the numbers the check compares; a
control that comes out correct on any seed fails the command.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, harness, inputs  # noqa: E402
from benchmark.kinds import engine as engine_kind  # noqa: E402
from benchmark.reference import build as ref_build  # noqa: E402
from benchmark.reference import engine as ref_engine  # noqa: E402

def inputs_of(spec: dict, seed: int, device) -> tuple:
    """-> ([contigs of each pool entry], [filter words of each entry])."""
    cfg, traffic = spec["config"], spec["traffic"]
    if traffic["kind"] == "engine":
        pool = engine_kind.make_pool(cfg, traffic, seed, device)
        return pool.entries, [pool.words] * len(pool.entries)
    from benchmark.kinds import reads as reads_kind

    cell = reads_kind.Cell(cfg, traffic, seed, device, {})
    words = []
    for ent in cell.entries:
        r = torch.from_numpy(ent["reads"].reshape(-1, ent["reads"].shape[-1])).to(device)
        can = ref_build.read_hashes(r, cfg["k"])
        _f1, f0, spec_ = ref_build.histogram(can)
        words.append(ref_build.read_filter(can, cfg["k"], f0, spec_, traffic["cutoff"], cfg["hash_num"]))
    cell.close()
    return [ent["contigs"] for ent in cell.entries], words


def control_numbers(spec: dict, seed: int, device, bits: int = 0) -> dict:
    cfg, traffic = spec["config"], spec["traffic"]
    bits = bits or traffic["check"]["control_bits"]
    entries, words = inputs_of(spec, seed, device)
    k, h = cfg["k"], cfg["hash_num"]
    cfg_ref = ref_engine.engine_config(k, h, cfg["engine"], traffic.get("mode") == "snv")
    c = traffic["check"]
    rng = inputs.host_rng(seed, 6)
    contigs = [(i, n, s.tobytes()) for i, e in enumerate(entries) for n, s in e
               if len(s) >= cfg_ref.min_contig_len]
    weights = np.array([len(s) for _, _, s in contigs], dtype=np.float64)
    totals = {"differing_rows": 0, "differing_bases": 0, "rows_compared": 0}
    for _ in range(c["stretches"]):
        i, name, s = contigs[int(rng.choice(len(contigs), p=weights / weights.sum()))]
        st = check.pick_stretch(len(s), [], rng, k, cfg_ref.max_deletions, c["width"])
        if st is None:
            continue
        q0, _c0, _e, b = st
        control = ref_engine.HostFilter(words[i], h, probe_bits=bits)
        mine = check.parse(ref_engine.run(name, s[q0:b], control, cfg_ref))[name]
        prog = [s[:q0].decode() + mine[0]] + [[(p + q0, r) for p, r in mine[col]] for col in (1, 2)]
        got = check.compare_stretch(name, s, prog, st, ref_engine.HostFilter(words[i], h), cfg_ref)
        totals["differing_rows"] += got["rows"]
        totals["differing_bases"] += got["bases"]
        totals["rows_compared"] += got["rows_compared"]
    return totals


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bits", type=int, default=0, help="probe bits (default: the cell's control_bits)")
    args = ap.parse_args()
    spec = harness.load_spec(args.workload)
    failed_all = True
    for seed in args.seeds:
        t = time.perf_counter()
        got = control_numbers(spec, seed, "cuda", args.bits)
        correct = got["differing_rows"] == 0 and got["differing_bases"] == 0
        failed_all &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_bits": args.bits or spec["traffic"]["check"]["control_bits"],
                          "correct": correct, **got, "seconds": time.perf_counter() - t}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
