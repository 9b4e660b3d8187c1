"""Polish pipeline: the device gate pass streamed into the exact C++ repair.

The throughput-dominant work — one canonical multi-hash + Bloom probe per
draft base — runs on the device (engine/flag.py over the CUDA gate
kernel); the sparse, branchy repair of gated sites runs on the host in the
threaded native engine (engine/native_repair.py), which jumps over
stretches the device proved clean and behaves exactly like the full
sequential scan elsewhere.  The device computes chunk i+1's gates while
-t host threads repair chunk i's segments.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine import flag, native_repair
from ntedit_tpu_torch.engine.config import EngineConfig
from ntedit_tpu_torch.engine.records import ContigResult

NOT_PORTED = "is not ported to the torch package yet (see ROADMAP.md)"


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain torch version on the CPU")
    return dev


class Polisher:
    """Reusable polisher: load filters once, polish many contigs."""

    def __init__(
        self,
        host_bloom,
        host_bloomrep=None,
        cfg: Optional[EngineConfig] = None,
        chunk: int = flag.DEFAULT_CHUNK,
        device=None,
    ):
        self.device = resolve_device(device)
        if cfg is None:
            cfg = EngineConfig(k=host_bloom.k, hash_num=host_bloom.hash_num)
        if cfg.k == 0:
            cfg = dataclasses.replace(cfg, k=host_bloom.k, hash_num=host_bloom.hash_num)
        self.cfg = cfg.validate()
        if self.cfg.snv:
            raise NotImplementedError(f"SNV mode (-s 1) {NOT_PORTED}")
        if self.cfg.verbose:
            raise NotImplementedError(f"verbose tracing (-v 1) {NOT_PORTED}")
        self.bloom = host_bloom
        self.bloomrep = host_bloomrep
        self.chunk = chunk
        self.df = bloom.DeviceFilter.from_host(host_bloom, self.device)

    def gate_positions(self, seq: np.ndarray) -> np.ndarray:
        """One-shot dense gate pass over a whole contig."""
        return flag.flag_contig_gates(
            seq, self.df, snv=self.cfg.snv,
            min_threshold=self.cfg.min_threshold, chunk=self.chunk,
        )

    def polish_contig(self, header: str, seq: np.ndarray) -> ContigResult:
        """Stream the contig's gates from the device into the threaded
        repair.  Each call runs its device work on a CUDA stream of its
        own, so two contigs in flight never share one."""
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        streamed = []
        chunks = flag.iter_gate_chunks(
            seq, self.df, snv=False, min_threshold=self.cfg.min_threshold,
            chunk=self.chunk, stream=stream,
        )
        res = native_repair.polish_contig_pipelined(
            self.bloom, self.bloomrep, self.cfg, header, seq, chunks,
            threads=self.cfg.threads, collect_gates=streamed,
        )
        if res is not None:
            return res
        # a segment run failed: replay the whole contig through the native
        # engine with the gates already computed as its hint
        hint = np.concatenate(streamed) if streamed else self.gate_positions(seq)
        res = native_repair.polish_contig_native(
            self.bloom, self.bloomrep, self.cfg, header, seq, gate_hint=hint)
        if res is None:
            # the JAX package falls back to its wavefront engine here
            raise NotImplementedError(
                f"native repair failed on contig {header!r}; the wavefront fallback {NOT_PORTED}")
        return res

    def polish(
        self, contigs: Iterable[Tuple[str, np.ndarray]]
    ) -> Iterator[ContigResult]:
        """Polish a stream of (header, seq) contigs.  Contigs shorter than
        min_contig_len are read but produce no output (reference behaviour,
        ntedit.cpp:2242-2245).

        With -t > 1, contigs overlap two deep on two host threads (the next
        contig's gate pass runs while the current one repairs), each on its
        own CUDA stream; results are yielded strictly in input order."""
        if self.cfg.threads <= 1:
            for header, seq in contigs:
                if len(seq) >= self.cfg.min_contig_len:
                    yield self.polish_contig(header, seq)
            return
        with ThreadPoolExecutor(max_workers=2) as ex:
            pending = deque()
            for header, seq in contigs:
                if len(seq) < self.cfg.min_contig_len:
                    continue
                pending.append(ex.submit(self.polish_contig, header, seq))
                while len(pending) > 2:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
