"""What the repair engine returns for one contig, and what the writers
read: the substitution records, the rope of spans and insertions, and the
contig with its substitutions applied.

A copy of the parts of the JAX package's engine/oracle.py that the native
repair binding and the writers consume (the scalar Oracle itself is not
part of the port yet).
"""

from __future__ import annotations

import dataclasses

CHAR = 1  # field of an inserted cell [-1, char, ins_support, span_support]


@dataclasses.dataclass(slots=True)
class SubRec:
    """sRec (ntedit.cpp:598-611)."""

    pos: int
    draft_char: int
    sub_base: int
    num_support: int
    altbase1: int = 0
    altsupp1: int = 0
    altbase2: int = 0
    altsupp2: int = 0
    altbase3: int = 0
    altsupp3: int = 0


class RopeCells:
    """seqNode rope (the reference's edit structure, ntedit.cpp:613-620).

    ``nodes`` is a list of ["span", s_pos, e_pos, sup] (a contiguous range
    of the original contig; the reference's type-0 node) and ["ins", cell]
    (one inserted character; type-1), where ``cell`` is
    [-1, char, ins_support, span_support]."""

    __slots__ = ("nodes", "_len")

    def __init__(self, n: int, nodes: list | None = None):
        if nodes is None:
            nodes = [["span", 0, n - 1, 0]] if n else []
        self.nodes = nodes
        self._len = n

    def __len__(self) -> int:
        return self._len


@dataclasses.dataclass
class ContigResult:
    header: str
    contig: bytearray          # original-length sequence with subs/masks applied
    cells: RopeCells           # the edited sequence as a rope
    subs: list                 # queued SubRec in scan order

    @property
    def edited(self) -> bytes:
        parts = []
        for nd in self.cells.nodes:
            if nd[0] == "span":
                parts.append(bytes(self.contig[nd[1] : nd[2] + 1]))
            else:
                parts.append(bytes([nd[1][CHAR]]))
        return b"".join(parts)
