"""Star multiple-sequence alignment + indel tensor construction.

Replaces the reference's MUSCLE subprocess per candidate/haplotype
(generate_indel_pileups.py:30-31 — its single hottest operation,
SURVEY.md §3.3) with an in-process star MSA: every read window is
aligned to the reference window with affine NW, then projected into
common columns (ref positions + per-anchor insertion blocks,
insertions left-aligned within a block).

The column-statistics → tensor/consensus math mirrors
generate_indel_pileups.py:53-73 exactly: channel0 = per-column base
frequency minus ref one-hot, channel1 = ref one-hot, consensus = argmax
with a −0.01 nudge against '-', truncate/pad to 128 columns.
"""

from __future__ import annotations

import numpy as np

# read-vs-ref alignment scoring for MSA construction (gap-lenient, since
# ONT reads carry frequent short indels; MUSCLE was run with a tiny gap
# penalty at generate_indel_pileups.py:29-30)
MSA_MATCH = 5
MSA_MISMATCH = -4
MSA_GAP_OPEN = 8
MSA_GAP_EXTEND = 1

MSA_WIDTH = 128

_MAP = {"A": 0, "G": 1, "T": 2, "C": 3, "-": 4}
_REV = "AGTC-"

_CODE_LUT = np.full(256, 4, dtype=np.int8)
for _b, _c in _MAP.items():
    _CODE_LUT[ord(_b)] = _c


def _row_codes(row):
    return _CODE_LUT[np.frombuffer(row.encode(), dtype=np.uint8)]


def msa_sample(seq_list, v_pos, maxcov):
    """Deterministic maxcov downsample; sorted read names (the reference
    sorts its sample at generate_indel_pileups.py:22)."""
    sample = sorted(seq_list.keys())
    if len(sample) > maxcov:
        rng = np.random.default_rng((812 << 32) | (int(v_pos) & 0xFFFFFFFF))
        pick = rng.choice(len(sample), size=maxcov, replace=False)
        sample = [sample[i] for i in sorted(pick)]
    return sample


def star_msa_from_cigars(seqs, cigars, ref, mincov, use_native=True):
    """Column projection + tensor given precomputed read-vs-ref cigars
    ([(op, len)] lists or packed uint32 (len<<4|op) run arrays).

    Runs the C++ projection of io/native (ncio_msa_project); the numpy
    path below, taken with use_native=False, is its bit-identical oracle.
    """
    if len(seqs) < mincov:
        return (0, 0, None, None, None)
    if use_native:
        from ..io.native import msa_project_native

        tensor, cns = msa_project_native([_row_codes(s) for s in seqs],
                                         cigars, _row_codes(ref),
                                         width=MSA_WIDTH)
        return (1, 1, tensor, cns, ref)
    rows, ref_row = project_alignments(seqs, cigars, ref)
    tensor, cns, ref_degapped = msa_tensor(rows, ref_row)
    return (1, 1, tensor, cns, ref_degapped)


def project_alignments(seqs, cigars, ref):
    """Project per-read pairwise alignments into MSA rows.

    Returns (read_rows list[str], ref_row str). Column layout: for each
    ref position j an insertion block of max-insertion-length(anchor j)
    columns precedes ref column j; a trailing block sits after the last
    ref position. Inserted bases are left-aligned in their block.
    """
    from .nw import unpack_cigar

    m = len(ref)
    ins_len = np.zeros(m + 1, dtype=np.int64)
    parsed = []
    for seq, cigar in zip(seqs, map(unpack_cigar, cigars)):
        qi = ri = 0
        events = []  # (anchor_ref_pos, kind, payload)
        for op, l in cigar:
            if op in (7, 8, 0):
                events.append((ri, "M", seq[qi : qi + l]))
                qi += l
                ri += l
            elif op == 1:
                events.append((ri, "I", seq[qi : qi + l]))
                ins_len[ri] = max(ins_len[ri], l)
                qi += l
            elif op == 2:
                events.append((ri, "D", l))
                ri += l
        parsed.append(events)

    # column start offset of ref position j (after its insertion block)
    col_of_ref = np.zeros(m, dtype=np.int64)
    off = 0
    for j in range(m):
        off += ins_len[j]
        col_of_ref[j] = off
        off += 1
    total_cols = off + ins_len[m]

    ref_row_arr = np.full(total_cols, ord("-"), dtype=np.uint8)
    ref_bytes = np.frombuffer(ref.encode(), dtype=np.uint8)
    ref_row_arr[col_of_ref] = ref_bytes

    rows = []
    for events in parsed:
        row = np.full(total_cols, ord("-"), dtype=np.uint8)
        for anchor, kind, payload in events:
            if kind == "M":
                cols = col_of_ref[anchor : anchor + len(payload)]
                row[cols] = np.frombuffer(payload.encode(), dtype=np.uint8)
            elif kind == "I":
                if anchor < m:
                    start = col_of_ref[anchor] - ins_len[anchor]
                else:
                    start = total_cols - ins_len[m]
                pb = np.frombuffer(payload.encode(), dtype=np.uint8)
                row[start : start + len(pb)] = pb
            # deletions remain '-'
        rows.append(row.tobytes().decode())
    return rows, ref_row_arr.tobytes().decode()


def msa_tensor(rows, ref_row, width=MSA_WIDTH):
    """Column stats → ((5,128,2) tensor, consensus, de-gapped ref);
    formula parity with generate_indel_pileups.py:53-73."""
    ref_codes = _row_codes(ref_row).astype(np.int64)
    ref_oh = np.eye(5, dtype=np.float32)[ref_codes]  # (cols, 5)
    mat = np.stack([_row_codes(r) for r in rows]).astype(np.int64)
    counts = np.eye(5, dtype=np.float32)[mat].sum(axis=0)  # (cols, 5)
    alt = counts / counts.sum(axis=1, keepdims=True)
    tmp = alt.copy()
    tmp[:, 4] -= 0.01
    cns = "".join(_REV[i] for i in np.argmax(tmp, axis=1)).replace("-", "")
    ref_degapped = ref_row.replace("-", "")
    alt = alt - ref_oh
    final = np.dstack([alt, ref_oh])[:width].transpose(1, 0, 2)
    if final.shape[1] < width:
        final = np.concatenate(
            [final, np.zeros((5, width - final.shape[1], 2), np.float32)], axis=1)
    return final.astype(np.float32), cns, ref_degapped
