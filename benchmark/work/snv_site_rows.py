"""Work the SNV site rows need, from the algorithm (the Oracle's fix of an
SNV-mode site, ``reference/oracle.py``): at each candidate head h, whose
site is p = h + k - 1, the confirmation windows at heads h + 1 + kk and,
for each alternate base whose window is in the filter, the same windows
with p holding that base, for kk = 0, j, 2j, ... < k; each probed once.
Written once: a row a candidate, its position and four counts of at most
k (8 bytes)."""

from __future__ import annotations

import torch

from benchmark.reference import device as rd

ROW_BYTES = 8


def needs(seq: torch.Tensor, table: torch.Tensor, k: int, hash_num: int, cfg) -> tuple:
    """-> (bytes streamed, sector ids of the filter words probed, ops)."""
    n = seq.numel() - k + 1
    words = table.shape[0]
    valid, iupac = rd.window_flags(seq, n, k)
    fh, rh = rd.window_hashes(seq, k)
    present = []
    for allowed, can in rd.alternate_hashes(seq, n, k):
        present.append(allowed & valid & rd.contains(table, can, hash_num))
    cand = torch.nonzero(valid & (iupac | present[0] | present[1] | present[2] | present[3])).flatten()
    ftab, rtab = rd._rotated_tables(k, seq.device)
    s = seq.long()
    sectors = []
    for kk in range(0, k, cfg.jump):
        w = cand + 1 + kk
        w = w[w < n]
        h = w - 1 - kk
        own = rd.canonical(fh[w], rh[w])
        sectors.append(torch.unique(rd.word_and_mask(own, words, hash_num)[0] >> 3))
        i = k - 2 - kk  # the site's index in the window at head w
        if i < 0:
            continue
        site = s[h + k - 1]
        for b, pres in zip(b"ACGT", present):
            hb = h[pres[h]]
            old = site[pres[h]]
            f = fh[hb + 1 + kk] ^ ftab[i * 256 + old] ^ ftab[i * 256 + b]
            r = rh[hb + 1 + kk] ^ rtab[i * 256 + old] ^ rtab[i * 256 + b]
            sectors.append(torch.unique(rd.word_and_mask(rd.canonical(f, r), words, hash_num)[0] >> 3))
    return cand.numel() * ROW_BYTES, torch.unique(torch.cat(sectors)), 0

