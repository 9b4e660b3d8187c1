"""Kernels of another checkout of the repository, for timing in turns with
this checkout's on the same data (chip_smoke.py, utils/gate_sweep.py,
utils/build_sweep.py and utils/snv_sweep.py, each with ``--against DIR``).

A source is built from ``DIR/ntedit_tpu_torch/csrc`` with this checkout's
nvcc flags and that checkout's headers into this checkout's ``_build/``.
Make such a checkout with ``git archive <commit> ntedit_tpu_torch/csrc |
tar -x -C DIR`` into a directory that .gitignore lists (``_work/``).
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ntedit_tpu_torch.ops import build_kernel as bk
from ntedit_tpu_torch.ops import gate_kernel, snv_kernel
from ntedit_tpu_torch.utils import build


def library_path(other: str, source: str, name: str) -> str:
    """Build ``source`` (a file name under the other checkout's csrc/) as
    ``name``; returns the .so path."""
    csrc = os.path.join(other, "ntedit_tpu_torch", "csrc")
    deps = tuple(os.path.join(csrc, f) for f in sorted(os.listdir(csrc)) if f.endswith(".cuh"))

    def command(src, out):
        cmd = gate_kernel._command(src, out)
        cmd[cmd.index("-I") + 1] = csrc  # the other checkout's headers
        return cmd

    return build.build_library(name, os.path.join(csrc, source), command, deps=deps)


def _ok(rc: int, what: str, other: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} of {other} failed: CUDA error {rc}")


class DenseHashes:
    """The dense hashes kernel of a checkout before the compacted one
    (``ntb_kmer_hashes``: every window's canonical hash, 0 where invalid,
    and validity words), with that checkout's compaction in torch."""

    @staticmethod
    def offered(other: str) -> bool:
        """Whether the checkout at ``other`` still has the dense kernel."""
        return hasattr(ctypes.CDLL(library_path(other, "build_kernel.cu", "build_kernel_other")),
                       "ntb_kmer_hashes")

    def __init__(self, other: str):
        self.other = other
        lib = ctypes.CDLL(library_path(other, "build_kernel.cu", "build_kernel_other"))
        ptr, u64, i32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
        lib.ntb_kmer_hashes.restype = i32
        lib.ntb_kmer_hashes.argtypes = [ptr, u64, i32, ptr, ptr, ptr]
        self.lib = lib

    def kernel(self, seq: torch.Tensor, n: int, k: int) -> tuple:
        hashes = torch.empty(n, dtype=torch.int64, device=seq.device)
        valid = torch.empty(-(-n // 32), dtype=torch.int32, device=seq.device)
        _ok(self.lib.ntb_kmer_hashes(seq.data_ptr(), n, k, hashes.data_ptr(), valid.data_ptr(),
                                     bk._stream(seq)), "kmer_hashes", self.other)
        return hashes, valid

    def valid_hashes(self, seq: torch.Tensor, n: int, k: int) -> torch.Tensor:
        """The kernel, then the compaction (unpack the words, boolean index)."""
        hashes, words = self.kernel(seq, n, k)
        return hashes[bk.unpack_bits(words, n)]


class CandWords:
    """The SNV candidate kernel of another checkout (``nts_cand_words``)."""

    def __init__(self, other: str):
        self.other = other
        lib = ctypes.CDLL(library_path(other, "snv_kernel.cu", "snv_kernel_other"))
        ptr, u64, i32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
        lib.nts_cand_words.restype = i32
        lib.nts_cand_words.argtypes = [ptr, u64, i32, ptr, u64, u64, i32, i32, i32, ptr, ptr]
        self.lib = lib

    def words(self, seq: torch.Tensor, n: int, df) -> torch.Tensor:
        out = torch.empty(-(-n // 32), dtype=torch.int32, device=seq.device)
        _ok(self.lib.nts_cand_words(seq.data_ptr(), n, df.k, *snv_kernel._filter_args(df),
                                    out.data_ptr(), torch.cuda.current_stream(seq.device).cuda_stream),
            "nts_cand_words", self.other)
        return out


class SiteRows:
    """The site-row kernel of another checkout (``nts_site_rows``, both
    forms, the C interface of this checkout's)."""

    def __init__(self, other: str):
        self.other = other
        self.lib = ctypes.CDLL(library_path(other, "snv_kernel.cu", "snv_kernel_other"))
        snv_kernel.declare_site_rows(self.lib)

    def rows(self, seq: torch.Tensor, n: int, heads: torch.Tensor, df, jump: int,
             polish: bool) -> torch.Tensor:
        return snv_kernel._site_rows(seq, n, heads, df, jump, polish, self.lib)
