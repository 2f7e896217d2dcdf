"""Affine-gap global alignment (Gotoh) with traceback.

Replaces parasail's ``nw_trace`` (reference: generate_indel_pileups.py:10,79
— gap open 9, extend 1, match 20, mismatch −10; a gap of length k costs
open + (k−1)·extend, i.e. the first gap residue pays `open`). Cigar op
codes follow the htslib/parasail convention consumed by the reference's
allele_prediction walk: 7 '=', 8 'X', 1 'I' (extra query base / gap in
ref), 2 'D' (gap in query / extra ref base).

Layout: rows i = query, cols j = ref. Vertical moves consume query
(op I), horizontal moves consume ref (op D). The horizontal gap state is
computed per-row with a prefix-max identity (exact for affine costs:
chaining two gaps through an intermediate cell is never strictly better
than one long gap since open ≥ extend ≥ 0). Tie-breaking prefers
diagonal, then the gap states; exact-tie traceback may differ from
parasail's — downstream allele extraction is validated behaviorally.
"""

from __future__ import annotations

import numpy as np

# encode: A0 C1 G2 T3, everything else 4 (always mismatches)
_CHAR_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _CHAR_CODE[ord(_b)] = _i
    _CHAR_CODE[ord(_b.lower())] = _i


def _codes(s):
    return _CHAR_CODE[np.frombuffer(s.encode(), dtype=np.uint8)]


def nw_align(query, ref, match=20, mismatch=-10, gap_open=9, gap_extend=1):
    """Global affine alignment; returns (score, cigar)."""
    q = _codes(query)
    r = _codes(ref)
    n, m = len(q), len(r)
    if n == 0 and m == 0:
        return 0, []
    if n == 0:
        return -(gap_open + (m - 1) * gap_extend), [(2, m)]
    if m == 0:
        return -(gap_open + (n - 1) * gap_extend), [(1, n)]

    sub = np.full((5, 5), mismatch, dtype=np.int32)
    np.fill_diagonal(sub, match)
    sub[4, :] = mismatch
    sub[:, 4] = mismatch

    jext = np.arange(m + 1, dtype=np.int64) * gap_extend

    H = np.empty(m + 1, dtype=np.int64)
    H[0] = 0
    H[1:] = -(gap_open + jext[:-1])
    V = np.full(m + 1, -(1 << 40), dtype=np.int64)  # vertical gap (op I)

    # traceback: bits 0-1 H-source (0 diag, 1 V/I, 2 Z/D);
    # bit 2 V extends; bit 3 Z extends
    tb = np.zeros((n + 1, m + 1), dtype=np.uint8)
    tb[0, 1:] = 2 | 8
    tb[0, 1] = 2
    for i in range(1, n + 1):
        tb[i, 0] = 1 | (4 if i > 1 else 0)

    for i in range(1, n + 1):
        Hprev = H.copy()
        diag = Hprev[:-1] + sub[q[i - 1]][r]  # j = 1..m
        Vnew = np.maximum(Hprev[1:] - gap_open, V[1:] - gap_extend)
        v_ext = (V[1:] - gap_extend) > (Hprev[1:] - gap_open)
        H0 = -(gap_open + (i - 1) * gap_extend)
        # G = best of diag/vertical; horizontal gap Z via prefix max of G
        G = np.empty(m + 1, dtype=np.int64)
        G[0] = H0
        G[1:] = np.maximum(diag, Vnew)
        came_v = Vnew > diag
        c = G - gap_open + jext
        M = np.maximum.accumulate(c)
        Z = M[:-1] - jext[:-1]  # Z[j] for j=1..m (index 0 ↔ j=1)
        z_ext = np.zeros(m, dtype=bool)
        if m > 1:
            z_ext[1:] = M[:-2] > c[1:-1]  # extend beats opening at j-1
        Hnew = np.maximum(G[1:], Z)
        came_z = Z > G[1:]
        H[0] = H0
        H[1:] = Hnew
        V[1:] = Vnew
        row = np.where(came_z, 2, np.where(came_v, 1, 0)).astype(np.uint8)
        row |= (v_ext.astype(np.uint8) << 2)
        row |= (z_ext.astype(np.uint8) << 3)
        tb[i, 1:] = row

    return int(H[m]), _traceback(tb, q, r)


def _traceback(tb, q, r):
    i, j = len(q), len(r)
    ops = []
    state = 0  # 0 in H, 1 in V (op I), 2 in Z (op D)
    while i > 0 or j > 0:
        cell = tb[i, j]
        if state == 0:
            if j == 0:
                state = 1
                continue
            if i == 0:
                state = 2
                continue
            src = cell & 3
            if src == 0:
                ops.append(7 if q[i - 1] == r[j - 1] and q[i - 1] != 4 else 8)
                i -= 1
                j -= 1
            else:
                state = src
        elif state == 1:  # I: consume query, move up
            ops.append(1)
            ext = cell & 4
            i -= 1
            if not ext:
                state = 0
        else:  # D: consume ref, move left
            ops.append(2)
            ext = cell & 8
            j -= 1
            if not ext:
                state = 0
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return [(op, l) for op, l in cigar]


def pack_cigar(cigar):
    """[(op, len)] → read-only uint32 (len<<4|op) run array."""
    arr = np.fromiter(((l << 4) | op for op, l in cigar), np.uint32,
                      len(cigar))
    arr.flags.writeable = False
    return arr


def unpack_cigar(arr):
    """uint32 (len<<4|op) run array → [(op, len)] (identity on lists)."""
    if not isinstance(arr, np.ndarray):
        return arr
    return list(zip((arr & 0xF).tolist(), (arr >> 4).tolist()))
