"""Polish pipeline: the device gate pass streamed into the exact C++ repair.

The throughput-dominant work — one canonical multi-hash + Bloom probe per
draft base — runs on the device (engine/flag.py over the CUDA gate
kernel); the sparse, branchy repair of gated sites runs on the host in the
threaded native engine (engine/native_repair.py), which jumps over
stretches the device proved clean and behaves exactly like the full
sequential scan elsewhere.  The device computes chunk i+1's gates while
-t host threads repair chunk i's segments.

Two engines, as in the JAX package:

* ``pipelined`` (the default, also ``auto``): the streaming gate pass
  (flag.iter_gate_chunks) overlapped with the threaded segment repair
  (native_repair.polish_contig_pipelined).  With site rows, the stream
  carries rows parallel to each chunk's gates (flag.iter_polish_site_chunks)
  that the engine consumes at pristine windows instead of probing.
* ``native``: the whole contig's gate hint first, then the segmented
  repair (-t > 1) or the whole-contig engine.  With candidate masks, the
  device also computes at every gate which of the four bases the window's
  last position may take (flag.polish_candidate_masks), the engine's first
  substitution probe.

In SNV mode (-s 1) every head enters the engine's fix path, so the device
computes the candidate heads instead (ops/snv_kernel.py): the only heads
where a record or an edit can arise.  They are an exact hint for the
segmented repair, and the site rows the device computes for them stand in
for the engine's own probes.

The rows and the masks change no output byte, only where the probes run.
"""

from __future__ import annotations

import dataclasses
import queue
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
ENGINES = ("pipelined", "native")


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
        engine: str = "auto",
        site_rows: Optional[bool] = None,
        cand_masks: bool = False,
    ):
        """``engine``: "auto" (= "pipelined"), "pipelined" or "native".

        ``site_rows``: compute site rows on the device and hand them to the
        repair, in SNV mode (each candidate's) and with the pipelined engine
        in polish mode (each chunk's gates'); None means on in SNV mode and
        off in polish mode.  ``cand_masks``: with the native engine in
        polish mode, compute the candidate masks of the gates.  The outputs
        are the same either way; both apply only where the JAX package
        allows them (non-counting filter, no reject filter, -m != 2).  The
        polish-mode defaults follow the card's timing in turns at 50 Mbp
        (chip_smoke.py, PERF.md): the engine with rows was no slower in 4
        rounds of 5 in one run and 0 in another, with masks in 2 and 1."""
        self.device = resolve_device(device)
        if cfg is None:
            cfg = EngineConfig(k=host_bloom.k, hash_num=host_bloom.hash_num)
        if cfg.k == 0:
            cfg = dataclasses.replace(cfg, k=host_bloom.k, hash_num=host_bloom.hash_num)
        self.cfg = cfg.validate()
        if self.cfg.verbose:
            raise NotImplementedError(f"verbose tracing (-v 1) {NOT_PORTED}")
        if engine == "auto":
            engine = "pipelined"
        if engine in ("wavefront", "sequential"):
            raise NotImplementedError(f"the {engine} engine {NOT_PORTED}")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}: one of auto, {', '.join(ENGINES)}")
        self.engine = engine
        self.bloom = host_bloom
        self.bloomrep = host_bloomrep
        self.chunk = chunk
        self.site_rows = self.cfg.snv if site_rows is None else site_rows
        self.cand_masks = cand_masks
        self.df = bloom.DeviceFilter.from_host(host_bloom, self.device)
        # the binned SNV candidate pass's scratch (flag.cand_bins): one for
        # each contig in flight, taken by a call and given back after it
        self._cand_bins = queue.SimpleQueue()

    def gate_positions(self, seq: np.ndarray) -> np.ndarray:
        """One-shot dense gate pass over a whole contig."""
        return flag.flag_contig_gates(
            seq, self.df, snv=self.cfg.snv,
            min_threshold=self.cfg.min_threshold, chunk=self.chunk,
        )

    def _snv_fast_eligible(self) -> bool:
        """The SNV candidate hint is exact only when the alternate
        pre-check (contains && solid) is what the device computes and
        gating decisions cannot arise elsewhere: non-counting filter, no
        reject filter, mode != 2 (mode 2 bypasses the pre-check), mask off
        (masking touches every no-fix position)."""
        return (not self.df.counting and self.bloomrep is None
                and self.cfg.mode != 2 and not self.cfg.mask)

    def _polish_probes_eligible(self) -> bool:
        """Polish rows and candidate masks stand in for the engine's own
        probes only where those probes are plain contains: non-counting
        filter, no reject filter, mode != 2 (mode 2 bypasses the pre-check
        probe)."""
        return not self.df.counting and self.bloomrep is None and self.cfg.mode != 2

    def _snv_contig(self, header: str, seq: np.ndarray, stream) -> ContigResult:
        """SNV mode.  Eligible runs: the device's candidates (and their
        site rows) into the segmented repair with -t > 1, else into the
        whole-contig engine.  Other runs: the gate pass with snv=True (every
        valid head) as the whole-contig engine's hint."""
        rows = None
        res = None
        if self._snv_fast_eligible():
            try:
                bins = self._cand_bins.get_nowait()
            except queue.Empty:
                bins = flag.cand_bins(self.df, self.chunk)
            if self.site_rows:
                hint, rows = flag.snv_site_data(seq, self.df, self.cfg.jump, chunk=self.chunk,
                                                stream=stream, bins=bins)
            else:
                hint = flag.snv_candidate_positions(seq, self.df, chunk=self.chunk,
                                                    stream=stream, bins=bins)
            self._cand_bins.put(bins)  # the candidates are on the host: the bins are free
            if self.cfg.threads > 1:
                res = native_repair.polish_contig_segmented(
                    self.bloom, None, self.cfg, header, seq, hint,
                    threads=self.cfg.threads, allow_snv=True, site_rows=rows)
        else:
            hint = self.gate_positions(seq)
        if res is None:
            res = native_repair.polish_contig_native(
                self.bloom, self.bloomrep, self.cfg, header, seq, gate_hint=hint, site_rows=rows)
        if res is None:
            # the JAX package falls back to its wavefront engine here
            raise NotImplementedError(
                f"native repair failed on contig {header!r}; the wavefront fallback {NOT_PORTED}")
        return res

    def _native_contig(self, header: str, seq: np.ndarray, hint: np.ndarray,
                       stream) -> ContigResult:
        """Polish mode from a whole gate hint: the candidate masks of its
        gates when switched on, then the segmented repair (-t > 1) or the
        whole-contig engine."""
        masks = None
        if self.cand_masks and self._polish_probes_eligible() and len(hint):
            masks = flag.polish_candidate_masks(seq, self.df, hint, stream=stream)
        res = None
        if self.cfg.threads > 1:
            res = native_repair.polish_contig_segmented(
                self.bloom, self.bloomrep, self.cfg, header, seq, hint,
                threads=self.cfg.threads, gate_cand=masks)
        if res is None:
            res = native_repair.polish_contig_native(
                self.bloom, self.bloomrep, self.cfg, header, seq, gate_hint=hint,
                gate_cand=masks)
        if res is None:
            # the JAX package falls back to its wavefront engine here
            raise NotImplementedError(
                f"native repair failed on contig {header!r}; the wavefront fallback {NOT_PORTED}")
        return res

    def polish_contig(self, header: str, seq: np.ndarray) -> ContigResult:
        """Polish mode: the pipelined engine streams the contig's gates
        (with their rows) from the device into the threaded repair; the
        native engine takes the whole gate hint (and its masks) first.  SNV
        mode: the candidates into the segmented repair.  Each call runs its
        device work on a CUDA stream of its own, so two contigs in flight
        never share one."""
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        if self.cfg.snv:
            return self._snv_contig(header, seq, stream)
        if self.engine == "native":
            return self._native_contig(header, seq, self.gate_positions(seq), stream)
        streamed = []
        if self.site_rows and self._polish_probes_eligible():
            chunks = flag.iter_polish_site_chunks(
                seq, self.df, self.cfg.jump, chunk=self.chunk, stream=stream)
        else:
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
        # a segment run failed: replay the whole contig from the gates
        # already computed, as the native engine does
        hint = np.concatenate(streamed) if streamed else self.gate_positions(seq)
        return self._native_contig(header, seq, hint, stream)

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
