"""Polish pipeline: the device gate pass streamed into the exact C++ repair.

The throughput-dominant work — one canonical multi-hash + Bloom probe per
draft base — runs on the device (engine/flag.py over the CUDA gate
kernel); the sparse, branchy repair of gated sites runs on the host in the
threaded native engine (engine/native_repair.py), which jumps over
stretches the device proved clean and behaves exactly like the full
sequential scan elsewhere.  The device computes chunk i+1's gates while
-t host threads repair chunk i's segments.

Four engines, as in the JAX package:

* ``pipelined`` (the default, also ``auto``): the streaming gate pass
  (flag.iter_gate_chunks) overlapped with the threaded segment repair
  (native_repair.polish_contig_pipelined).  With site rows, the stream
  carries rows parallel to each chunk's gates (flag.iter_polish_site_chunks)
  that the engine consumes at pristine windows instead of probing.
* ``native``: the whole contig's gate hint first, then the segmented
  repair (-t > 1) or the whole-contig engine.  With candidate masks, the
  device also computes at every gate which of the four bases the window's
  last position may take, the engine's first substitution probe: gates and
  masks in one pass over the contig on the card
  (flag.contig_gates_and_masks).
* ``wavefront``: batched numpy rounds over the gate hint
  (engine/wavefront.py); in SNV mode over the device's candidate heads.
  A scan-order-dependent case it cannot batch (WavefrontBailout) goes to
  the sequential engine.
* ``sequential``: the Oracle itself (engine/oracle.py), the executable
  specification, fast-forwarding over the gate hint.

Where the native or the segmented repair returns None (a filter or input
it does not take), the contig goes to the wavefront engine and, on a
bail-out, to the sequential one, as in the JAX package.  With -v the
Oracle traces its trials on stdout, with the gate hint of the device.
The wavefront and the Oracle share one Oracle object and so run one
contig at a time.

In SNV mode (-s 1) every head enters the engine's fix path, so the device
computes the candidate heads instead (ops/snv_kernel.py): the only heads
where a record or an edit can arise.  They are an exact hint for the
segmented repair, and the site rows the device computes for them stand in
for the engine's own probes.

The rows and the masks change no output byte, only where the probes run.

Spans (utils/profiling.py): ``engine.load`` (the filter's upload and the
Oracle), ``engine.contig`` (a contig of ``polish``, with its ordinal in the
input), ``engine.gates`` (the device's gates or candidates of a contig, or
the wait for the next chunk of the stream; in SNV mode with the children
``engine.snv_pass`` and ``engine.download``, engine/flag.py),
``engine.repair`` (a native repair call, in the thread that runs it) and
``engine.fallback``; counters ``engine.bases``, ``engine.records``,
``engine.gates`` (the gates handed to the repair), ``engine.snv_candidates``
(the device's SNV candidates, once a contig), ``engine.site_rows`` (the
site rows handed to the repair) and ``engine.segments`` (the native calls
of a contig's segmented repair: its buckets, or 1 for a whole call; in the
pipelined repair, each bucket handed to the pool).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine import flag, native_repair, wavefront
from ntedit_tpu_torch.engine.config import EngineConfig
from ntedit_tpu_torch.engine.oracle import Oracle
from ntedit_tpu_torch.engine.records import ContigResult
from ntedit_tpu_torch.utils import profiling

ENGINES = ("pipelined", "native", "wavefront", "sequential")


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
        fast_sites: bool = True,
    ):
        """``engine``: "auto" (= "pipelined"), "pipelined", "native",
        "wavefront" or "sequential".  ``fast_sites``: the Oracle evaluates
        eligible sites with the batched site fixer (engine/sitefix.py).

        ``site_rows``: compute site rows on the device and hand them to the
        repair, in SNV mode (each candidate's) and with the pipelined engine
        in polish mode (each chunk's gates'); None means on in SNV mode and
        off in polish mode.  ``cand_masks``: with the native engine in
        polish mode, compute the candidate masks of the gates.  The outputs
        are the same either way; both apply only where the JAX package
        allows them (non-counting filter, no reject filter, -m != 2).  The
        polish-mode defaults follow the card's timing in turns at 50 Mbp
        (PERF.md section 6): the engine with rows was no slower in 4 rounds of
        5 in one run and 0 in another, with masks in 2 and 1."""
        self.device = resolve_device(device)
        if cfg is None:
            cfg = EngineConfig(k=host_bloom.k, hash_num=host_bloom.hash_num)
        if cfg.k == 0:
            cfg = dataclasses.replace(cfg, k=host_bloom.k, hash_num=host_bloom.hash_num)
        self.cfg = cfg.validate()
        if engine == "auto":
            engine = "pipelined"
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}: one of auto, {', '.join(ENGINES)}")
        self.engine = engine
        self.bloom = host_bloom
        self.bloomrep = host_bloomrep
        self.chunk = chunk
        self.site_rows = self.cfg.snv if site_rows is None else site_rows
        self.cand_masks = cand_masks
        with profiling.span("engine.load"):
            self.df = bloom.DeviceFilter.from_host(host_bloom, self.device)
            self.oracle = Oracle(host_bloom, host_bloomrep, self.cfg, fast=fast_sites)
        # the wavefront and sequential engines mutate the shared Oracle, and
        # polish() runs two contigs in flight: those paths take this lock
        self._oracle_lock = threading.Lock()
        # the binned SNV candidate pass's scratch (flag.cand_bins): one for
        # each contig in flight, taken by a call and given back after it
        self._cand_bins = queue.SimpleQueue()

    def gate_positions(self, seq: np.ndarray) -> np.ndarray:
        """One-shot dense gate pass over a whole contig."""
        with profiling.span("engine.gates"):
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

    def _snv_candidates(self, seq: np.ndarray, stream, rows: bool = False):
        """The device's SNV candidate heads (and with ``rows`` their site
        rows, as a pair), on the binned pass's scratch of this call."""
        try:
            bins = self._cand_bins.get_nowait()
        except queue.Empty:
            bins = flag.cand_bins(self.df, self.chunk)
        with profiling.span("engine.gates"):
            if rows:
                got = flag.snv_site_data(seq, self.df, self.cfg.jump, chunk=self.chunk,
                                         stream=stream, bins=bins)
            else:
                got = flag.snv_candidate_positions(seq, self.df, chunk=self.chunk,
                                                   stream=stream, bins=bins)
        self._cand_bins.put(bins)  # the candidates are on the host: the bins are free
        profiling.count("engine.snv_candidates", len(got[0] if rows else got))
        return got

    def _snv_contig(self, header: str, seq: np.ndarray, stream) -> ContigResult:
        """SNV mode.  Eligible runs: the device's candidates (and their
        site rows) into the segmented repair with -t > 1, else into the
        whole-contig engine.  Other runs: the gate pass with snv=True (every
        valid head) as the whole-contig engine's hint."""
        rows = cand = hint = None
        res = None
        if self._snv_fast_eligible():
            if self.site_rows:
                cand, rows = self._snv_candidates(seq, stream, rows=True)
                profiling.count("engine.site_rows", len(rows))
            else:
                cand = self._snv_candidates(seq, stream)
            if self.cfg.threads > 1:
                res = native_repair.polish_contig_segmented(
                    self.bloom, None, self.cfg, header, seq, cand,
                    threads=self.cfg.threads, allow_snv=True, site_rows=rows)
        else:
            hint = self.gate_positions(seq)
        if res is None:
            res = native_repair.polish_contig_native(
                self.bloom, self.bloomrep, self.cfg, header, seq,
                gate_hint=hint if cand is None else cand, site_rows=rows)
        if res is None:
            with profiling.span("engine.fallback"):
                return self._fallback(header, seq, hint, cand, stream)
        return res

    def _fallback(self, header: str, seq: np.ndarray, hint: Optional[np.ndarray] = None,
                  cand: Optional[np.ndarray] = None, stream=None) -> ContigResult:
        """The wavefront engine, then on a bail-out the sequential Oracle
        (the JAX package's polish.py:283-311).  ``hint`` is the gate pass's
        (computed here when None); the wavefront's heads are the gates in
        polish mode and in SNV mode the candidate heads ``cand`` (the
        device's when eligible, else every head)."""
        if self.cfg.snv:
            if cand is None:
                cand = (self._snv_candidates(seq, stream) if self._snv_fast_eligible()
                        else np.arange(max(0, len(seq) - self.cfg.k + 1)))
            heads = cand
        else:
            if hint is None:
                hint = self.gate_positions(seq)
            heads = hint
        with self._oracle_lock:
            try:
                return wavefront.polish_contig_wavefront(self.oracle, header, bytes(seq), heads)
            except wavefront.WavefrontBailout:
                pass  # a scan-order-dependent case: the sequential engine
        return self._sequential(header, seq, hint)

    def _sequential(self, header: str, seq: np.ndarray,
                    hint: Optional[np.ndarray] = None) -> ContigResult:
        """The Oracle's scan over the gate hint (computed here when None)."""
        if hint is None:
            hint = self.gate_positions(seq)
        with self._oracle_lock:
            return self.oracle.polish_contig(header, bytes(seq), gate_hint=hint)

    def _native_contig(self, header: str, seq: np.ndarray, stream,
                       hint: Optional[np.ndarray] = None) -> ContigResult:
        """Polish mode from a whole gate hint (the gate pass's when None):
        the candidate masks of its gates when switched on (with the gates,
        in one pass over the contig on the card, when the hint is computed
        here), then the segmented repair (-t > 1) or the whole-contig
        engine."""
        masks = None
        masked = self.cand_masks and self._polish_probes_eligible()
        if hint is None and masked:
            with profiling.span("engine.gates"):
                hint, masks = flag.contig_gates_and_masks(seq, self.df, chunk=self.chunk,
                                                          stream=stream)
        elif hint is None:
            hint = self.gate_positions(seq)
        elif masked:
            with profiling.span("engine.gates"):
                masks = flag.polish_candidate_masks(seq, self.df, hint, stream=stream)
        if not len(hint):
            masks = None
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
            with profiling.span("engine.fallback"):
                return self._fallback(header, seq, hint, stream=stream)
        return res

    def polish_contig(self, header: str, seq: np.ndarray) -> ContigResult:
        """Polish mode: the pipelined engine streams the contig's gates
        (with their rows) from the device into the threaded repair; the
        native engine takes the whole gate hint (and its masks) first.  SNV
        mode: the candidates into the segmented repair.  The wavefront and
        sequential engines, and -v (the Oracle, tracing), take the whole
        gate hint.  Each call runs its device work on a CUDA stream of its
        own, so two contigs in flight never share one."""
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        if self.cfg.verbose or self.engine == "sequential":
            return self._sequential(header, seq)
        if self.engine == "wavefront":
            return self._fallback(header, seq, stream=stream)
        if self.cfg.snv:
            return self._snv_contig(header, seq, stream)
        if self.engine == "native":
            return self._native_contig(header, seq, stream)
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
        return self._native_contig(header, seq, stream,
                                   np.concatenate(streamed) if streamed else None)

    def _polish_counted(self, ordinal: int, header: str, seq: np.ndarray) -> ContigResult:
        """``polish_contig`` as the span ``engine.contig`` of the input's
        contig ``ordinal``, its bases and records counted."""
        with profiling.span("engine.contig", contig=ordinal):
            res = self.polish_contig(header, seq)
        profiling.count("engine.bases", len(seq))
        profiling.count("engine.records", len(res.subs))
        return res

    def polish(
        self, contigs: Iterable[Tuple[str, np.ndarray]]
    ) -> Iterator[ContigResult]:
        """Polish a stream of (header, seq) contigs.  Contigs shorter than
        min_contig_len are read but produce no output (reference behaviour,
        ntedit.cpp:2242-2245).

        With -t > 1, contigs overlap two deep on two host threads (the next
        contig's gate pass runs while the current one repairs), each on its
        own CUDA stream; results are yielded strictly in input order.  With
        -v they do not, so each contig's trace follows the one before."""
        if self.cfg.threads <= 1 or self.cfg.verbose:
            for i, (header, seq) in enumerate(contigs):
                if len(seq) >= self.cfg.min_contig_len:
                    yield self._polish_counted(i, header, seq)
            return
        with ThreadPoolExecutor(max_workers=2) as ex:
            pending = deque()
            for i, (header, seq) in enumerate(contigs):
                if len(seq) < self.cfg.min_contig_len:
                    continue
                pending.append(ex.submit(self._polish_counted, i, header, seq))
                while len(pending) > 2:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
