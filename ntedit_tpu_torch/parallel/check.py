"""Run the mesh programs in one rank of a process group, on inputs read
from an .npz file, and write their results to another .npz file.

    python -m ntedit_tpu_torch.parallel.check --init URL --world N --rank R \\
        --inputs IN.npz --out OUT.npz [--device cpu|cuda]

Every rank of the group runs it with the same inputs; each writes what it
holds after each program, so that a caller can check that every rank holds
the same result and compare it with a reference.  Inputs (any may be left
out, and the programs on it are skipped):

* ``or_parts`` int32 [D, m], ``sat_parts`` uint8 [D, m]: rank r's array
  for ``ring_or`` / ``saturating_add_allreduce`` is row r;
* ``rows`` uint8 [R, Lr] with ``k``, ``hash_num``, ``nbits``, ``slots``:
  ``sharded_bf_build`` and ``sharded_cbf_build``;
* ``tiles`` uint8 [T, chunk + k - 1] with ``filter_data`` (a plain
  filter's bytes, ``hash_num``, ``k``): ``sharded_flag``;
* ``draft`` uint8 with the same filter (and ``chunk``, 0 for the
  automatic width): ``iter_sharded_gate_chunks`` (frontiers and gates) and
  ``sharded_polish``, its three output files rendered as text;
* always: ``gather_records`` of ``[(rank, "r" * rank)]`` as JSON, and
  the rank of this process in ``make_mesh(1)`` (``sub_rank``: -1 outside
  it) with ``ring_or`` over that mesh of rank 0's ``or_parts`` row.
"""

from __future__ import annotations

import argparse
import io
import json

import numpy as np
import torch

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine.config import EngineConfig
from ntedit_tpu_torch.io import writers
from ntedit_tpu_torch.parallel import distributed, mesh as pmesh


def _text(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8)


def run(inputs: dict, device) -> dict:
    """The programs on ``inputs`` in this rank of the default group."""
    m = pmesh.make_mesh(device=device)
    out = {}

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    if "or_parts" in inputs:
        out["or"] = host(pmesh.ring_or(torch.from_numpy(inputs["or_parts"][m.rank]), m))
    if "sat_parts" in inputs:
        out["sat"] = host(pmesh.saturating_add_allreduce(
            torch.from_numpy(inputs["sat_parts"][m.rank]), m))
    k = int(inputs["k"]) if "k" in inputs else 0
    hash_num = int(inputs["hash_num"]) if "hash_num" in inputs else 0
    if "rows" in inputs:
        out["bf"] = host(pmesh.sharded_bf_build(m, inputs["rows"], k, hash_num,
                                                int(inputs["nbits"])))
        out["cbf"] = host(pmesh.sharded_cbf_build(m, inputs["rows"], k, hash_num,
                                                  int(inputs["slots"])))
    if "filter_data" in inputs:
        hf = bloom.KmerBloomFilter(np.array(inputs["filter_data"]), hash_num, k)
        words = bloom._pack_words(hf.data)
        if "tiles" in inputs:
            out["flag"] = host(pmesh.sharded_flag(m, inputs["tiles"], words, k=k,
                                                  hash_num=hash_num, nbits=hf.bits))
        if "draft" in inputs:
            cfg = EngineConfig(k=k, hash_num=hash_num).validate()
            draft = inputs["draft"]
            chunk = int(inputs["chunk"]) or None
            frontiers, gates = [], []
            for f, g in pmesh.iter_sharded_gate_chunks(m, draft, words, cfg, nbits=hf.bits,
                                                       cbytes=0, blocked=False,
                                                       counting=False, chunk=chunk):
                frontiers.append(f)
                gates.append(g)
            out["frontiers"] = np.asarray(frontiers, dtype=np.int64)
            out["gates"] = np.concatenate(gates) if gates else np.zeros(0, np.int64)
            res = pmesh.sharded_polish(m, "ctg", draft, hf, words, cfg, chunk=chunk)
            sinks = io.StringIO(), io.StringIO(), io.StringIO()
            writers.write_contig(res, *sinks, {})
            for name, sink in zip(("fa", "tsv", "vcf"), sinks):
                out[f"polish_{name}"] = _text(sink.getvalue())
    records = distributed.gather_records([(m.rank, "r" * m.rank)])
    out["records"] = _text(json.dumps(records))
    sub = pmesh.make_mesh(1, device=device)
    out["sub_rank"] = np.int64(sub.rank)
    if sub.rank == 0 and "or_parts" in inputs:
        out["sub_or"] = host(pmesh.ring_or(torch.from_numpy(inputs["or_parts"][0]), sub))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ntedit_tpu_torch.parallel.check",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--init", required=True, help="the process group's init_method URL")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    with np.load(args.inputs) as f:
        inputs = {key: f[key] for key in f.files}
    distributed.initialize(num_processes=args.world, process_id=args.rank,
                           device=args.device, init_method=args.init)
    try:
        np.savez(args.out, **run(inputs, args.device))
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
