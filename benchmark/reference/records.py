"""What the repair engines return for one contig, and what the writers

Frozen for the benchmark's plain reference: a copy of
``ntedit_tpu_torch/engine/records.py`` as the benchmark was written, importing
nothing of the port, so that a later change to the port does not
change what the port is held to.
read: the substitution records, the edited sequence (a rope of spans and
insertions, or the Oracle's cell list) and the contig with its
substitutions applied.

The parts of the JAX package's engine/oracle.py that the Oracle, the
wavefront engine, the native repair binding and the writers share, copied
(the port keeps its own host code).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# cell field indices
ORIG = 0   # original coordinate, -1 for inserted characters
CHAR = 1   # character (only authoritative for inserted cells)
INS_SUP = 2  # insertion support (rope char-node num_support)
SPAN_SUP = 3  # deletion support marker (rope node num_support after a gap)


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
    """seqNode rope (the reference's edit structure, ntedit.cpp:613-620)
    behind a minimal cell-list facade.

    ``nodes`` is a list of ["span", s_pos, e_pos, sup] (a contiguous range
    of the original contig; the reference's type-0 node) and ["ins", cell]
    (one inserted character; type-1), where ``cell`` is a mutable
    [-1, char, support, 0] list whose identity is preserved across
    __getitem__ so in-place field writes stick.  Span cells are read-only
    views (their edits go through ``contig``); the one span-cell field
    write the engine performs (post-deletion support, makeDeletion's record
    at ntedit.cpp:719-809) goes through set_span_sup, which splits the
    node.  Construction is O(1) and splices are O(nodes), so a contig pays
    for its edits, not its length."""

    __slots__ = ("nodes", "_cum", "_len")

    def __init__(self, n: int, nodes: list | None = None):
        """``n`` cells; ``nodes`` (default one span of the whole contig) is
        a node list of that length, as the native repair engine returns."""
        if nodes is None:
            nodes = [["span", 0, n - 1, 0]] if n else []
        self.nodes = nodes
        self._cum = None
        self._len = n

    # -- index mapping --
    def _cumlens(self) -> np.ndarray:
        if self._cum is None:
            lens = [
                nd[2] - nd[1] + 1 if nd[0] == "span" else 1 for nd in self.nodes
            ]
            self._cum = np.concatenate(
                [np.zeros(1, dtype=np.int64), np.cumsum(lens, dtype=np.int64)]
            )
        return self._cum

    def _locate(self, i: int):
        cum = self._cumlens()
        ni = int(np.searchsorted(cum, i, side="right")) - 1
        return ni, i - int(cum[ni])

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self._len)
            return [self[j] for j in range(start, stop, step)]
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError(i)
        ni, off = self._locate(i)
        nd = self.nodes[ni]
        if nd[0] == "span":
            return [nd[1] + off, 0, 0, nd[3]]
        return nd[1]

    def __iter__(self):
        for nd in self.nodes:
            if nd[0] == "span":
                for p in range(nd[1], nd[2] + 1):
                    yield [p, 0, 0, nd[3]]
            else:
                yield nd[1]

    # -- structural edits --
    def _split_at(self, i: int) -> int:
        """Ensure a node boundary at cell index i; return the index of the
        node that starts at i (== len(nodes) when i == len(self))."""
        if i == self._len:
            return len(self.nodes)
        ni, off = self._locate(i)
        if off == 0:
            return ni
        nd = self.nodes[ni]  # mid-span (ins nodes have length 1)
        self.nodes[ni] = ["span", nd[1], nd[1] + off - 1, nd[3]]
        self.nodes.insert(ni + 1, ["span", nd[1] + off, nd[2], nd[3]])
        if self._cum is not None:  # incremental: one boundary appears
            self._cum = np.insert(self._cum, ni + 1, self._cum[ni] + off)
        return ni + 1

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            start, stop, _ = i.indices(self._len)
            if start != stop:
                raise NotImplementedError("rope supports insertion splices only")
            ni = self._split_at(start)
            m = len(v)
            self.nodes[ni:ni] = [["ins", c] for c in v]
            if self._cum is not None:  # m unit-length boundaries appear
                cum = self._cum
                self._cum = np.concatenate(
                    [cum[: ni + 1], cum[ni] + 1 + np.arange(m), cum[ni + 1 :] + m]
                )
            self._len += m
            return
        raise NotImplementedError("single-cell assignment not used by the engine")

    def __delitem__(self, i):
        if not isinstance(i, slice):
            i = slice(i, i + 1)
        start, stop, _ = i.indices(self._len)
        if start >= stop:
            return
        a = self._split_at(start)
        b = self._split_at(stop)
        del self.nodes[a:b]
        if self._cum is not None:
            cum = self._cum
            self._cum = np.concatenate([cum[: a + 1], cum[b + 1 :] - (stop - start)])
        self._len -= stop - start

    def walk(self, lo: int, n: int):
        """Yield cells [lo, lo+n) as (orig, char) pairs in one node walk
        (no per-index bisection).  orig < 0 marks an inserted cell whose
        byte is ``char``; span cells yield (orig, -1)."""
        if n <= 0 or lo >= self._len:
            return
        ni, off = self._locate(lo)
        remaining = min(n, self._len - lo)
        while remaining > 0 and ni < len(self.nodes):
            nd = self.nodes[ni]
            if nd[0] == "span":
                start = nd[1] + off
                cnt = min(nd[2] - start + 1, remaining)
                for p in range(start, start + cnt):
                    yield (p, -1)
                remaining -= cnt
            else:
                yield (-1, nd[1][CHAR])
                remaining -= 1
            ni += 1
            off = 0

    def pristine_run(self, idx: int, n: int):
        """If cells [idx, idx+n) form one coordinate-contiguous run of
        ORIGINAL cells, return the run's starting contig coordinate, else
        None.  O(log nodes + nodes crossed) — the per-cell __getitem__ loop
        this replaces dominated the wavefront profile."""
        if idx < 0 or idx + n > self._len:
            return None
        ni, off = self._locate(idx)
        nd = self.nodes[ni]
        if nd[0] != "span":
            return None
        start = nd[1] + off
        covered = nd[2] - start + 1
        expect = nd[2] + 1
        while covered < n:
            ni += 1
            nd = self.nodes[ni]
            if nd[0] != "span" or nd[1] != expect:
                return None
            covered += nd[2] - nd[1] + 1
            expect = nd[2] + 1
        return start

    def seq_at(self, idx: int, L: int) -> int:
        """Contig coordinate of cell idx (the _seq_of convention: an
        original cell maps to its own coordinate; otherwise nearest-
        previous-original + 1; 0 when no original cell precedes idx)."""
        if 0 <= idx < self._len:
            ni, off = self._locate(idx)
            nd = self.nodes[ni]
            if nd[0] == "span":
                return nd[1] + off
        else:
            if self._len == 0:
                return 0
            ni = len(self.nodes)  # scan back from the last node
        while ni > 0:
            ni -= 1
            nd = self.nodes[ni]
            if nd[0] == "span":
                return nd[2] + 1
        return 0

    def seq_of_many(self, idxs: np.ndarray) -> np.ndarray:
        """Vectorized seq_at over sorted in-range cell indices."""
        cum = self._cumlens()
        arr = np.asarray(idxs, dtype=np.int64)
        ni = np.searchsorted(cum, arr, side="right") - 1
        nodes = self.nodes
        is_span = np.fromiter(
            (nd[0] == "span" for nd in nodes), dtype=bool, count=len(nodes)
        )
        s_pos = np.fromiter(
            (nd[1] if nd[0] == "span" else 0 for nd in nodes),
            dtype=np.int64, count=len(nodes),
        )
        e_pos = np.fromiter(
            (nd[2] if nd[0] == "span" else -1 for nd in nodes),
            dtype=np.int64, count=len(nodes),
        )
        # seq value an INSERTED cell in node i maps to: end+1 of the nearest
        # span node strictly before i (coordinates are monotone along the
        # rope, so "nearest before" == running max)
        run = np.maximum.accumulate(np.where(is_span, e_pos + 1, 0))
        prev_span_end = np.concatenate([[0], run[:-1]])
        out = np.where(
            is_span[ni], s_pos[ni] + (arr - cum[ni]), prev_span_end[ni]
        )
        return out

    def compat_deletion_len(self, idx: int, n_del: int) -> int:
        """Effective deletion length under reference rope semantics
        (rope_compat): ``makeDeletion`` computes
        ``leftover_del = pos + num_del - e_pos`` when a deletion consumes a
        type-0 node past its end (ntedit.cpp:739,767) — one more than the
        clean remainder — so every span-node exit adds one extra deleted
        base, cascading; a leftover with no following node is dropped
        (ntedit.cpp:773-780).  Char (insertion) nodes consume without the
        off-by-one (ntedit.cpp:782-808).  Node boundaries in this rope are
        exactly the reference's: both structures split only at edit sites
        (set_span_sup never splits in practice — the deletion path has
        already placed a boundary at the support cell)."""
        if idx >= self._len:
            return 0
        ni, off = self._locate(idx)
        remaining = n_del
        total = 0
        while remaining > 0 and ni < len(self.nodes):
            nd = self.nodes[ni]
            if nd[0] == "span":
                avail = (nd[2] - nd[1] + 1) - off
                if remaining < avail:
                    total += remaining
                    remaining = 0
                else:
                    total += avail
                    remaining = remaining - avail + 1  # the off-by-one
            else:
                # consecutive char nodes consume one each, exactly
                take = 1 if remaining >= 1 else 0
                total += take
                remaining -= take
            ni += 1
            off = 0
        return min(total, self._len - idx)

    def set_span_sup(self, i: int, sup: int) -> None:
        ni = self._split_at(i)
        nd = self.nodes[ni]
        if nd[0] == "span":
            nd[3] = sup
        else:
            nd[1][3] = sup
        # a mid-span split leaves two coordinate-contiguous span nodes; the
        # writers merge those back into one run, reproducing the cell-list
        # behavior (a mid-run support write is invisible until a deletion
        # gap starts a run there)


@dataclasses.dataclass
class ContigResult:
    header: str
    contig: bytearray          # original-length sequence with subs/masks applied
    cells: list                # current cell list (the edited sequence)
    subs: list                 # queued SubRec in scan order

    @property
    def edited(self) -> bytes:
        nodes = getattr(self.cells, "nodes", None)
        if nodes is not None:
            parts = []
            for nd in nodes:
                if nd[0] == "span":
                    parts.append(bytes(self.contig[nd[1] : nd[2] + 1]))
                else:
                    parts.append(bytes([nd[1][CHAR]]))
            return b"".join(parts)
        out = bytearray()
        for c in self.cells:
            out.append(self.contig[c[ORIG]] if c[ORIG] >= 0 else c[CHAR])
        return bytes(out)
