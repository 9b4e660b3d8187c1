"""Work the polish-mode gate pass needs: every valid window of the draft
probed once, the draft read once, one gate bit a head written once."""

from __future__ import annotations

import torch

from benchmark.reference import device as rd


def needs(seq: torch.Tensor, table: torch.Tensor, k: int, hash_num: int, cfg) -> tuple:
    """-> (bytes streamed, sector ids of the filter words probed, ops)."""
    n = seq.numel() - k + 1
    valid, _ = rd.window_flags(seq, n, k)
    fh, rh = rd.window_hashes(seq, k)
    widx, _ = rd.word_and_mask(rd.canonical(fh, rh)[valid], table.shape[0], hash_num)
    return seq.numel() + (n + 7) // 8, torch.unique(widx >> 3), 0
