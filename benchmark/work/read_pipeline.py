"""Work the card needs for one ``polish --reads`` job, from the algorithm:
the reads read once (the histogram, count and insert passes all read the
same reads), each count-min counter sector the reads' k-mers raise, each
filter sector the solid k-mers set, the draft read once, each filter
sector its windows probe, and one gate bit a head written once."""

from __future__ import annotations

import torch

from benchmark.reference import build as ref_build
from benchmark.reference import device as rd


def needs(reads: torch.Tensor, draft: torch.Tensor, cfg: dict, traffic: dict) -> tuple:
    """-> (bytes streamed, distinct 32-byte sectors touched, ops)."""
    k, h = cfg["k"], cfg["hash_num"]
    can = ref_build.read_hashes(reads.reshape(-1, reads.shape[-1]), k)
    _f1, f0, spec = ref_build.histogram(can)
    cutoff = traffic["cutoff"]
    n_solid = max(1, f0 - int(spec[1:cutoff].sum()))
    words = ref_build.pow2_size_bytes(n_solid, h) * 8 // 32
    slots = 1 << max(12, (ref_build.bf_size_bytes(f0, h) * 8 - 1).bit_length())
    idx = [x & (slots - 1) for x in ref_build.extend(can, k, h)]
    counters = torch.bincount(torch.cat(idx), minlength=slots).clamp(max=255)
    counter_sectors = torch.unique(torch.cat(idx) >> 5).numel()
    solid = can[torch.stack([counters[i] for i in idx]).min(0).values >= cutoff]
    n = draft.numel() - k + 1
    valid, _ = rd.window_flags(draft, n, k)
    fh, rh = rd.window_hashes(draft, k)
    probed = rd.canonical(fh, rh)[valid]
    filt = torch.cat([rd.word_and_mask(solid, words, h)[0], rd.word_and_mask(probed, words, h)[0]])
    filter_sectors = torch.unique(filt >> 3).numel()
    streamed = reads.numel() + draft.numel() + (n + 7) // 8
    return streamed, counter_sectors + filter_sectors, 0
