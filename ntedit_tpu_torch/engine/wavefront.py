"""Wavefront repair: batched multi-site editing with exact sequential
semantics.

The sequential scan (oracle.polish_contig) is an inherently serial walk;
but edits are sparse and their influence is local — an edit at window head
``g`` can only change the gate state or fix decision of heads within
``g + k + max_deletions`` (its window-overlap zone).  The wavefront engine
exploits this:

  round:
    1. evaluate the round's *leader* sites in parallel against round-start
       state (batched confirmation / substitution / indel stages over
       pristine sites; scalar spec path inline for non-pristine ones).
       A leader is a pending gate more than one influence zone right of
       the previous leader: a draft error flags a run of ~k consecutive
       heads, but the sequential scan only ever pays for the first — the
       rest become clean (or re-gated) once the leader's decision lands,
       so evaluating them against round-start state is wasted work;
    2. commit decisions left-to-right.  A no-edit decision always commits.
       After an *edit* commits, its influence zone is immediately
       re-flagged against live content: if the zone is quiet (no new gates,
       no deferred sites inside), committing continues; otherwise all
       remaining sites of the round are deferred (they sit right of
       unresolved work, and sequential order owns them next round).
       Shadowed (non-leader) sites inside a committed zone are dropped —
       the zone re-flag re-derived the live gates there; shadowed sites
       beyond every committed zone (their leader declined to edit) are
       deferred and lead the next round.

This reproduces the sequential result exactly: a decision commits only
when every site to its left is final and its own window was evaluated
against final content (held to the oracle by the tests).  On clean drafts with sparse errors, one round
commits ~99% of sites.

Rare bail-outs (whole contig falls back to the sequential engine):
insertion low-complexity rollbacks (require >= k inserted bases at one
locus) whose re-seed semantics are scan-order-dependent.

A copy of the JAX package's module of the same name.
"""

from __future__ import annotations

import numpy as np

from ntedit_tpu_torch.core import nthash_ref as nh
from ntedit_tpu_torch.engine import oracle as _oracle
from ntedit_tpu_torch.engine import sitefix
from ntedit_tpu_torch.engine.oracle import (
    CHAR,
    ORIG,
    ContigResult,
    Oracle,
    _upper,
    find_first_accepted_kmer,
)


class WavefrontBailout(Exception):
    pass


def _seq_of(cells, idx: int, L: int) -> int:
    if isinstance(cells, _oracle.RopeCells):
        return cells.seq_at(idx, L)
    if idx < len(cells) and cells[idx][ORIG] >= 0:
        return cells[idx][ORIG]
    j = min(idx, len(cells)) - 1
    while j >= 0:
        if cells[j][ORIG] >= 0:
            return cells[j][ORIG] + 1
        j -= 1
    return 0


def _char_at(oracle, idx: int) -> int:
    c = oracle.cells[idx]
    return oracle.contig[c[ORIG]] if c[ORIG] >= 0 else c[CHAR]


def _window_bytes(oracle, lo: int, n: int) -> bytes:
    """Live cell contents [lo, lo+n) in one rope walk."""
    cells = oracle.cells
    if isinstance(cells, _oracle.RopeCells):
        contig = oracle.contig
        return bytes(
            contig[orig] if orig >= 0 else ch for orig, ch in cells.walk(lo, n)
        )
    return bytes(_char_at(oracle, i) for i in range(lo, min(lo + n, len(cells))))


def polish_contig_wavefront(
    oracle: Oracle, header: str, seq: bytes, gate_heads: np.ndarray,
    eval_chunk: int = 1 << 15,
) -> ContigResult:
    cfg = oracle.cfg
    k = cfg.k
    L = len(seq)
    oracle.contig = bytearray(seq)
    oracle.cells = _oracle.RopeCells(L)
    oracle.subs = []
    result = ContigResult(header, oracle.contig, oracle.cells, oracle.subs)

    h0 = find_first_accepted_kmer(0, bytes(seq), k)
    if h0 + k - 1 >= L:
        return result
    gh = np.asarray(gate_heads, dtype=np.int64)
    pending = gh[(gh >= h0) & (gh <= L - k)]
    infl = k + cfg.max_deletions  # influence reach of one edit, seq coords
    span = sitefix.span_for(cfg)
    any_indel = False  # while False, cell index == seq coordinate everywhere
    carry = {}  # h_seq -> (draft_char, best, zone_offsets): evaluations that
    #             survived a deferral; valid until an edit's zone covers them

    while len(pending):
        pending = np.unique(pending)
        batch = pending[:eval_chunk]
        rest = pending[eval_chunk:]
        new_pending = []      # list of np.int64 arrays
        new_single = []       # scalar deferrals

        # ---- classify: greedy leader per influence window; shadowed
        # sites are grouped into the segment trailing their leader ----
        cells_n = len(oracle.cells)
        leaders = []  # (cell_idx, h_seq, pristine)
        segs = []     # per leader: shadowed sites that follow it
        if not any_indel:
            # identity mapping: vectorized selection, segments as arrays
            arr = np.asarray(batch, dtype=np.int64)
            arr = arr[arr + k - 1 < L]
            seqs = arr
        else:
            arr = np.asarray(batch, dtype=np.int64)
            arr = arr[arr + k - 1 < cells_n]
            seqs = oracle.cells.seq_of_many(arr) if len(arr) else arr
            keep = seqs + k - 1 < L
            arr, seqs = arr[keep], seqs[keep]
        p = 0
        n_arr = len(arr)
        while p < n_arr:
            hc, hs = int(arr[p]), int(seqs[p])
            pristine = (
                hc + span <= cells_n and hc == hs
                if not any_indel
                else sitefix.site_pristine(oracle, hc, hs)
            )
            leaders.append((hc, hs, pristine))
            nxt = int(np.searchsorted(seqs, hs + infl, side="right"))
            segs.append((arr[p + 1 : nxt], seqs[p + 1 : nxt]))
            p = nxt

        # ---- evaluate pristine leader sites in batch ----
        decisions = {}
        zones = {}
        pr = []
        for s in leaders:
            if not s[2]:
                continue
            c = carry.get(s[1])
            if c is not None:
                # stale-but-valid decision from an earlier round: content
                # within reach of this site is untouched (invalidation
                # below drops every key inside a committed edit's zone)
                decisions[s[0]] = (c[0], c[1])
                if c[2] is not None:
                    zones[s[0]] = c[2]
            else:
                pr.append(s)
        if pr:
            base = np.frombuffer(bytes(oracle.contig), dtype=np.uint8)
            hseqs = np.fromiter((s[1] for s in pr), dtype=np.int64, count=len(pr))
            W = base[hseqs[:, None] + np.arange(span)]
            dc = W[:, k - 1]
            draft_chars = np.where(
                (dc >= 97) & (dc <= 122), dc - 32, dc
            ).astype(np.uint8)
            conf = sitefix.confirm_batch(oracle, W, draft_chars)
            # substitution batching only where a fix will actually be tried
            need = np.zeros(len(pr), dtype=bool)
            for i in range(len(pr)):
                if not conf.gate[i]:
                    continue
                need[i] = cfg.snv or (
                    not conf.do_not_fix[i]
                    and (
                        conf.check_missing[i] >= cfg.missing_needed
                        or (
                            oracle.bloom.is_counting
                            and conf.there_median[i] < cfg.min_threshold
                        )
                    )
                )
            alts = np.zeros((len(pr), 4), dtype=np.uint8)
            pre_ok = np.zeros((len(pr), 4), dtype=bool)
            present = np.zeros((len(pr), 4), dtype=np.int64)
            if need.any():
                sub_a, sub_p, sub_s = sitefix.subs_batch(
                    oracle, W[need], draft_chars[need]
                )
                alts[need], pre_ok[need], present[need] = sub_a, sub_p, sub_s
            simple, simple_bests = sitefix.decide_simple_batch(
                oracle, conf, draft_chars, alts, pre_ok, present,
                need & conf.gate,
            )
            gens = {}
            requests = {}
            for i, (hc, h_seq, _) in enumerate(pr):
                if not conf.gate[i]:
                    # pending was stale: the window itself is live-present
                    decisions[hc] = (int(draft_chars[i]), None)
                    continue
                if not need[i]:
                    decisions[hc] = (int(draft_chars[i]), None)
                    continue
                if simple[i]:
                    decisions[hc] = (int(draft_chars[i]), simple_bests[i])
                    continue
                g = sitefix.decide_site_gen(
                    oracle, W[i], int(draft_chars[i]), conf, i,
                    alts[i], pre_ok[i], present[i],
                )
                try:
                    requests[i] = g.send(None)
                    gens[i] = g
                except StopIteration as stop:
                    decisions[hc] = (int(draft_chars[i]), stop.value)
            # staged batched indel evaluation
            while requests:
                idxs = sorted(requests)
                sub_w = W[idxs]
                ics = np.array([requests[i][0] for i in idxs])
                dss = np.array([requests[i][1] for i in idxs])
                los = np.array([requests[i][2] for i in idxs])
                his = np.array([requests[i][3] for i in idxs])
                ins_sup, del_sup = sitefix.indel_batch(
                    oracle, sub_w, ics, dss, los, his
                )
                nxt = {}
                for row, i in enumerate(idxs):
                    try:
                        nxt[i] = gens[i].send((ins_sup[row], del_sup[row]))
                    except StopIteration as stop:
                        decisions[pr[i][0]] = (int(draft_chars[i]), stop.value)
                requests = nxt

        # ---- precompute zone re-flags for pristine edit decisions in one
        # batch: an edit at a pristine site leaves the zone content fully
        # known at evaluation time (original slice with the base patched /
        # insertion spliced / deletion skipped), so the per-commit live
        # re-flag — the dominant serial cost — collapses to a lookup.
        # Safe because leaders are > infl apart: no earlier commit of this
        # round can touch a later leader's zone content (indels only shift
        # cell indices, which the commit loop handles via delta). ----
        if pr:
            zi = [
                i for i, (hc, _h, _p) in enumerate(pr)
                if decisions.get(hc, (0, None))[1] is not None
                and decisions[hc][1]["type"] in (1, 2, 3)
            ]
            if zi:
                max_ins_len = min(cfg.max_insertions, 5)
                ZW = infl + max_ins_len + k - 1
                nheads = ZW - k + 1
                rows = np.full((len(zi), ZW), ord("A"), dtype=np.uint8)
                J = np.empty(len(zi), dtype=np.int64)
                # substitutions (the vast majority): one vectorized pass
                types = np.fromiter(
                    (decisions[pr[i][0]][1]["type"] for i in zi),
                    dtype=np.int64, count=len(zi),
                )
                sub_r = np.nonzero(types == 1)[0]
                if len(sub_r):
                    zlen = infl + k - 1
                    rows[sub_r, :zlen] = W[[zi[r] for r in sub_r], 1 : zlen + 1]
                    rows[sub_r, k - 2] = [
                        decisions[pr[zi[r]][0]][1]["sub_base"] for r in sub_r
                    ]
                    J[sub_r] = infl
                for r, i in enumerate(zi):
                    if types[r] == 1:
                        continue
                    b = decisions[pr[i][0]][1]
                    w = W[i]
                    if b["type"] == 2:  # insertion: splice before anchor
                        s = np.frombuffer(b["indel"].encode(), np.uint8)
                        li = len(s)
                        zlen = infl + li + k - 1
                        rows[r, : k - 2] = w[1 : k - 1]
                        rows[r, k - 2 : k - 2 + li] = s
                        rows[r, k - 2 + li : zlen] = w[k - 1 : k - 1 + zlen - (k - 2) - li]
                        J[r] = infl + li
                    else:  # deletion: skip d bases at the cursor
                        d = len(b["indel"])
                        zlen = infl - d + k - 1
                        rows[r, : k - 2] = w[1 : k - 1]
                        rows[r, k - 2 : zlen] = w[k - 1 + d : k - 1 + d + zlen - (k - 2)]
                        J[r] = infl - d
                zc, _zs, zcnt = sitefix._bulk(oracle, rows)
                zgate = np.full(zc.shape, cfg.snv) | ~zc
                if oracle.bloom.is_counting and cfg.min_threshold > 1:
                    zgate |= zcnt < cfg.min_threshold
                accw = sitefix._ACC[rows].astype(np.int64)
                cs = np.cumsum(
                    np.concatenate([np.zeros((len(zi), 1), np.int64), accw], axis=1),
                    axis=1,
                )
                zgate &= (cs[:, k:] - cs[:, :nheads]) == k
                zgate &= np.arange(nheads)[None, :] < J[:, None]
                for r, i in enumerate(zi):
                    zones[pr[i][0]] = np.nonzero(zgate[r])[0] + 1
            for hc, h_seq, _p in pr:
                if hc in decisions:
                    dc_, b_ = decisions[hc]
                    carry[h_seq] = (dc_, b_, zones.get(hc))

        # ---- commit left-to-right ----
        delta = 0
        blocked = False
        edit_hs = []
        infl_end = -1  # influence horizon of the last committed edit
        for (hc, h_seq, pristine), seg in zip(leaders, segs):
            committed_skip = False
            if blocked:
                if h_seq > infl_end:
                    new_single.append(hc + delta)
                committed_skip = True
            elif h_seq <= infl_end:
                # inside a committed edit's influence zone: the zone
                # re-flag already re-derived live gates there; the stale
                # round-start decision must not commit
                committed_skip = True
            if not committed_skip:
                hc_adj = hc + delta
                edited = False
                best = None
                if pristine:
                    # pristine site: tail cell is the original at h_seq+k-1
                    st = [hc_adj, h_seq, hc_adj + k - 1, h_seq + k - 1]
                    draft_char, best = decisions[hc]
                    if best is not None:
                        n_before = len(oracle.cells)
                        if best["type"] == 1:
                            oracle.commit_sub_pristine(draft_char, best, st[3])
                            edited = True
                        else:
                            _guard_rollback(oracle, best, st)
                            _fh, _rh, edited = oracle._make_edit(
                                draft_char, best, st, np.uint64(0), np.uint64(0),
                                patch_hash=False,
                            )
                else:
                    # scalar spec path, evaluated against *current* state
                    st = [
                        hc_adj,
                        h_seq,
                        hc_adj + k - 1,
                        _seq_of(oracle.cells, hc_adj + k - 1, L),
                    ]
                    window = _window_bytes(oracle, st[0], k)
                    fh = nh.base_forward_hash(window, k)
                    rh = nh.base_reverse_hash(window, k)
                    # live gate re-check (zone-derived sites were gated
                    # already, but state may have changed within the round)
                    hv = oracle._hashes(fh, rh)
                    gate = (
                        cfg.snv
                        or not oracle.bloom.contains(hv)
                        or (
                            oracle.bloom.is_counting
                            and oracle.bloom.get_count(hv) < cfg.min_threshold
                        )
                    )
                    if gate:
                        draft_char = _upper(_char_at(oracle, st[2]))
                        n_before = len(oracle.cells)
                        _check_rollback_risk(oracle, st)
                        _fh, _rh, edited = oracle._fix_site(draft_char, st, fh, rh)
                if edited:
                    if len(oracle.cells) != n_before:
                        any_indel = True
                    delta += len(oracle.cells) - n_before
                    infl_end = h_seq + infl
                    edit_hs.append(h_seq)
                    if (
                        pristine
                        and best is not None
                        and best["type"] == 3
                        and n_before - len(oracle.cells) != len(best["indel"])
                    ):
                        # rope_compat extended the deletion across a prior-
                        # edit node boundary: the precomputed zone assumed
                        # the clean length — re-flag live instead
                        zones.pop(hc, None)
                        carry.pop(h_seq, None)
                    if pristine and best is not None and hc in zones:
                        zg = zones[hc] + hc_adj
                        quiet = not len(zg)
                    else:
                        zone_gates, quiet = _reflag_zone(oracle, st, h_seq, infl, L)
                        zg = np.asarray(zone_gates, dtype=np.int64)
                    if len(zg):
                        new_pending.append(zg)
                    if not quiet:
                        blocked = True
            # trailing shadowed segment: drop sites a committed edit's zone
            # re-flag owns; defer the rest (they lead the next round)
            shc, shs = seg
            keep = shs > infl_end
            if keep.any():
                new_pending.append(shc[keep] + delta)

        if edit_hs and carry:
            E = np.asarray(edit_hs, dtype=np.int64)  # committed left-to-right
            keys = np.fromiter(carry.keys(), np.int64, len(carry))
            pos = np.searchsorted(E, keys, side="right") - 1
            bad = (pos >= 0) & (E[pos] + infl >= keys)
            for hs in keys[bad]:
                carry.pop(int(hs), None)
        if new_single:
            new_pending.append(np.asarray(new_single, dtype=np.int64))
        if len(rest):
            new_pending.append(rest + delta)
        pending = (
            np.concatenate(new_pending) if new_pending
            else np.empty(0, dtype=np.int64)
        )
    # commits from deferred rounds can land out of scan order; the
    # sequential engine emits records in strictly increasing position
    oracle.subs.sort(key=lambda r: r.pos)
    return result


def _guard_rollback(oracle, best: dict, st) -> None:
    """Insertion rollbacks re-seed scanning in a scan-order-dependent way;
    bail to the sequential engine when one would trigger
    (ntedit.cpp:1312-1344)."""
    if best["type"] == 2:
        prev = oracle._prev_insertion(st[2])
        if len(prev) + len(best["indel"]) >= oracle.cfg.k:
            raise WavefrontBailout("insertion low-complexity rollback")


def _check_rollback_risk(oracle, st) -> None:
    """Scalar-path equivalent of _guard_rollback: a rollback is only
    possible if an insertion run of length >= k - 5 precedes the cursor."""
    prev = oracle._prev_insertion(st[2])
    if len(prev) + 5 >= oracle.cfg.k:
        raise WavefrontBailout("possible insertion rollback")


def _reflag_zone(oracle, st, h_seq: int, infl: int, L: int):
    """Live-gate the influence zone of a just-committed edit.

    Returns (zone_gate_cells, quiet).  Heads from st[0]+1 while their seq
    coordinate <= h_seq + infl are re-evaluated against current content;
    quiet means no gates were found (committing may continue)."""
    cfg = oracle.cfg
    k = cfg.k
    cells = oracle.cells
    gates = []
    idx0 = st[0] + 1
    end_seq = h_seq + infl
    # one rope walk covers the zone heads plus their window tails
    # (insertions can only add cfg.insertion_cap cells to the zone)
    max_cells = infl + k + cfg.insertion_cap + 8
    if isinstance(cells, _oracle.RopeCells):
        walked = list(cells.walk(idx0, max_cells))
    else:
        walked = [
            (c[0], c[1] if c[0] < 0 else -1)
            for c in (
                cells[i] for i in range(idx0, min(idx0 + max_cells, len(cells)))
            )
        ]
    heads = []
    prev_orig = None
    seg_chars = []
    for j, (orig, ch) in enumerate(walked):
        if orig >= 0:
            hs = orig
            prev_orig = orig
            seg_chars.append(oracle.contig[orig])
        else:
            hs = (prev_orig + 1) if prev_orig is not None else _seq_of(
                cells, idx0 + j, L
            )
            seg_chars.append(ch)
        if hs <= end_seq:
            heads.append((idx0 + j, hs))
    if not heads:
        return gates, True
    n = len(heads)
    seg_end = min(heads[-1][0] + k, idx0 + len(walked))
    seg = np.array(seg_chars[: seg_end - idx0], dtype=np.uint8)
    # pathological zones (many capped insertion runs) can outgrow the walk
    want_end = min(heads[-1][0] + k, len(cells))
    if want_end > seg_end:
        seg = np.concatenate([
            seg,
            np.array(
                [_char_at(oracle, i) for i in range(seg_end, want_end)],
                dtype=np.uint8,
            ),
        ])
        seg_end = want_end
    W = np.zeros((n, k), dtype=np.uint8)
    valid = np.ones(n, dtype=bool)
    for i, (hidx, hs) in enumerate(heads):
        if hs + k - 1 >= L or hidx + k - 1 >= len(cells):
            valid[i] = False
            continue
        W[i] = seg[i : i + k]
    acc = sitefix._ACC[W].all(axis=1)
    contains, _solid, counts = sitefix._bulk(oracle, W)  # windows of width k -> 1 col
    present = contains[:, 0]
    gate = np.full(n, cfg.snv) | ~present
    if oracle.bloom.is_counting and cfg.min_threshold > 1:
        gate |= counts[:, 0] < cfg.min_threshold
    gate &= valid & acc
    for i, (hidx, hs) in enumerate(heads):
        if gate[i]:
            gates.append(hidx)
    return gates, len(gates) == 0
