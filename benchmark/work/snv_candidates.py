"""Work the SNV candidate pass needs: the three alternate windows of every
valid head probed once, the reference read once, one candidate bit a
head written once."""

from __future__ import annotations

import torch

from benchmark.reference import device as rd


def needs(seq: torch.Tensor, table: torch.Tensor, k: int, hash_num: int, cfg) -> tuple:
    """-> (bytes streamed, sector ids of the filter words probed, ops)."""
    n = seq.numel() - k + 1
    valid, _ = rd.window_flags(seq, n, k)
    sectors = []
    for allowed, can in rd.alternate_hashes(seq, n, k):
        widx, _ = rd.word_and_mask(can[valid & allowed], table.shape[0], hash_num)
        sectors.append(torch.unique(widx >> 3))
    return seq.numel() + (n + 7) // 8, torch.unique(torch.cat(sectors)), 0
