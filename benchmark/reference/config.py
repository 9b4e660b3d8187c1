"""Engine configuration — one typed config for all reference flags.

Frozen for the benchmark's plain reference: a copy of
``ntedit_tpu_torch/engine/config.py`` as the benchmark was written, importing
nothing of the port, so that a later change to the port does not
change what the port is held to.

Every field mirrors a reference engine flag with its default and clamping
rules (ntedit.cpp:99-169 and validation at 2411-2502).
"""

from __future__ import annotations

import dataclasses
from itertools import product


@dataclasses.dataclass
class EngineConfig:
    # k and hash_num come from the Bloom filter header, not flags
    # (ntedit.cpp:2439-2448).
    k: int = 0
    hash_num: int = 0
    # -t: host repair threads (reference default 4, ntedit.cpp:100,2432).
    # The reference parallelizes over contigs; this engine parallelizes
    # independent gate-run segments within a contig (native_repair.
    # polish_contig_segmented) and pipelines contigs, both exactly.
    threads: int = 4
    min_contig_len: int = 100        # -z
    max_insertions: int = 5          # -i (0..5)
    max_deletions: int = 5           # -d (0..10)
    missing_threshold: float = 5.0   # -x
    edit_threshold: float = 9.0      # -y
    use_ratio: bool = False          # set when -X or -Y given
    missing_ratio: float = 0.5       # -X
    edit_ratio: float = 0.5          # -Y
    jump: int = 3                    # -j
    mode: int = 0                    # -m (0/1/2)
    snv: bool = False                # -s
    mask: bool = False               # -a
    min_threshold: int = 1           # -p (CBF)
    max_threshold: int = 255         # -q (CBF)
    verbose: bool = False            # -v
    # Bug-compatible reference rope semantics (FIDELITY.md #1): a deletion
    # consuming past a rope-node end deletes one extra base per node exit
    # (makeDeletion leftover off-by-one, ntedit.cpp:739,767).  Node
    # boundaries exist only at prior edit sites, so this fires only when a
    # deletion spans a previous edit.  Default ON: byte-identity with the
    # reference is the acceptance bar; set False for the clean spec.
    rope_compat: bool = True

    @property
    def insertion_cap(self) -> int:
        # The reference unconditionally overrides any -c value with k*1.5
        # after loading the BF (ntedit.cpp:2450-2451) — the -c flag is dead
        # in v2.1.1.  We reproduce the effective behaviour.
        return int(self.k * 1.5)

    def validate(self) -> "EngineConfig":
        """Apply the reference's clamps (ntedit.cpp:2411-2493)."""
        cfg = dataclasses.replace(self)
        if cfg.snv:
            # SNV mode forces i = d = 0 (ntedit.cpp:2411-2413).
            cfg.max_insertions = 0
            cfg.max_deletions = 0
        # NOTE: the reference's x/y bounds check (ntedit.cpp:2467-2475) uses
        # && between mutually-exclusive conditions and can never fire; we
        # intentionally do not "fix" it (see FIDELITY.md).
        if (cfg.max_insertions == 0 and cfg.max_deletions > 0) or (
            cfg.max_insertions == 1 and cfg.max_deletions > 1
        ):
            cfg.max_deletions = cfg.max_insertions
        cfg.max_insertions = min(cfg.max_insertions, 5)
        cfg.max_deletions = min(cfg.max_deletions, 10)
        return cfg

    @property
    def missing_needed(self) -> float:
        """check_missing acceptance bound (ntedit.cpp:1865-1873)."""
        if self.use_ratio:
            return (self.k / self.jump) * self.missing_ratio
        return self.k / self.missing_threshold

    @property
    def present_needed(self) -> float:
        """check_present bound for subs/insertions (ntedit.cpp:1992-1997,
        1659-1663)."""
        if self.use_ratio:
            return (self.k / self.jump) * self.edit_ratio
        return self.k / self.edit_threshold

    @property
    def present_needed_deletion(self) -> float:
        """Deletions use (1 + k/j)·Y on the ratio path (ntedit.cpp:1531-1535)
        — asymmetric with insertions; reproduced as-is."""
        if self.use_ratio:
            return (1 + self.k / self.jump) * self.edit_ratio
        return self.k / self.edit_threshold


# Trial-count table: cumulative number of insertion strings of length <= i
# (sum of 4^0..4^(i-1)); reference num_tries (ntedit.cpp:172).
NUM_TRIES = [0, 1, 5, 21, 85, 341]

# Alternate-base tables (ntedit.cpp:180-199).  Polish mode maps IUPAC codes
# to their *complement* sets; SNV mode tries all four for IUPAC.
POLISH_BASES = {
    "A": "TCG", "T": "ACG", "C": "ATG", "G": "ATC",
    "R": "TC", "Y": "AG", "S": "AT", "W": "CG", "K": "AC", "M": "TG",
    "B": "A", "D": "C", "H": "G", "V": "T", "N": "ATCG",
}
SNV_BASES = {c: "ATCG" for c in "RYSWKMBDHVN"}
SNV_BASES.update({"A": "TCG", "T": "ACG", "C": "ATG", "G": "ATC"})


def _multi_bases(first: str) -> list[str]:
    """All insertion strings of length 1..5 starting with ``first``, ordered
    by length then lexicographically over ACGT — the exact trial order of
    the reference's multi_possible_bases table (ntedit.cpp:203-348)."""
    out = []
    for length in range(1, 6):
        for rest in product("ACGT", repeat=length - 1):
            out.append(first + "".join(rest))
    return out


MULTI_POSSIBLE_BASES = {b: _multi_bases(b) for b in "ACGT"}

ACGT = set(b"ACGT")
ACCEPTED = set(b"ATGCRYSWKMBDHV")  # isAcceptedBase (ntedit.cpp:493-499)

_RC = {ord(a): ord(b) for a, b in zip("AaTtGgCc", "TTAACCGG")}


def rc_char(c: int) -> int:
    """Reference RC(): complement of ACGT (case-folded), else 'N'
    (ntedit.cpp:501-520)."""
    return _RC.get(c, ord("N"))
