"""Carry a filter across from the JAX package: its filter arrays, passed as
numpy, become the port's host filter and DeviceFilter.  For this system the
filter is the state that stands where a model's weights would, so both
packages then probe the same bits.  SNV mode adds no state of its own: its
candidate and site passes read the same filters."""

from __future__ import annotations

import numpy as np

from ntedit_tpu_torch.core import bloom
from ntedit_tpu_torch.engine.polish import resolve_device

_HOST = {
    bloom.BLOCKED: (bloom.BlockedKmerBloomFilter, np.uint32),  # .words
    bloom.PLAIN: (bloom.KmerBloomFilter, np.uint8),            # .data
    bloom.COUNTING: (bloom.KmerCountingBloomFilter8, np.uint8),  # .counters
}


def filter_from_numpy(kind: str, array: np.ndarray, hash_num: int, k: int,
                      device=None) -> tuple:
    """(host filter, DeviceFilter) from a JAX filter's array:
    ``BlockedKmerBloomFilter.words`` (kind "blocked"),
    ``KmerBloomFilter.data`` ("plain") or
    ``KmerCountingBloomFilter8.counters`` ("counting")."""
    cls, dtype = _HOST[kind]
    host = cls(np.array(array, dtype=dtype), hash_num, k)
    return host, bloom.DeviceFilter.from_host(host, resolve_device(device))
