"""Batched affine NW on the device: BatchAligner over kernels K1 + K2.

The port of nanocaller_tpu/align/batch_nw.py::BatchAligner. Thousands of
(query, ref) pairs are padded into (Q, R) buckets; K1 (`nw_tb`) runs the
DP of a bucket in one launch and K2 (`nw_walk`) walks every traceback on
the device, so only the (B, T) op stream comes back to the host. Cigars
are identical to nw.nw_align (the tests assert it).

The DP of cell (i, j) reads only cells (≤i, ≤j), so it does not depend
on padding: the port drops the TPU's lane padding of R+1 to a multiple
of 128. A bucket's pairs are split so that no launch's traceback buffer
exceeds TB_CAP_BYTES.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.device import resolve_device
from .nw import _CHAR_CODE, nw_align
from .nw_kernels import nw_tb, nw_walk


def _traceback_matrix(tb, qlen, rlen):
    """Host traceback over one uint8 matrix (same walk as nw.py); the
    host oracle of K2."""
    i, j = int(qlen), int(rlen)
    ops = []
    state = 0
    while i > 0 or j > 0:
        cell = int(tb[i, j])
        if state == 0:
            if j == 0:
                state = 1
                continue
            if i == 0:
                state = 2
                continue
            src = cell & 3
            if src == 0:
                ops.append(("d", i, j))
                i -= 1
                j -= 1
            else:
                state = src
        elif state == 1:
            ops.append(("i", i, j))
            ext = cell & 4
            i -= 1
            if not ext:
                state = 0
        else:
            ops.append(("z", i, j))
            ext = cell & 8
            j -= 1
            if not ext:
                state = 0
    ops.reverse()
    return ops


def encode_pairs(pairs, Q, R):
    """(query, ref) strings → qcodes (n, Q) int8 and rcodes (n, R) int8
    (0-3 ACGT, 4 other and pad) and their (n,) int32 lengths: one bucket's
    inputs to K1 and K2."""
    n = len(pairs)
    qcodes = np.full((n, Q), 4, np.int8)
    rcodes = np.full((n, R), 4, np.int8)
    qlens = np.zeros(n, np.int32)
    rlens = np.zeros(n, np.int32)
    for b, (q, r) in enumerate(pairs):
        qa = _CHAR_CODE[np.frombuffer(q.encode(), dtype=np.uint8)]
        ra = _CHAR_CODE[np.frombuffer(r.encode(), dtype=np.uint8)]
        qcodes[b, : len(qa)] = qa
        rcodes[b, : len(ra)] = ra
        qlens[b] = len(qa)
        rlens[b] = len(ra)
    return qcodes, rcodes, qlens, rlens


class BatchAligner:
    """Pads string pairs into fixed (Q, R) buckets, runs K1 + K2 on
    `device` and turns the op streams into cigars identical to
    nw.nw_align. On device="cpu" the kernels' plain twins run."""

    BUCKETS = (64, 128, 192, 256, 320, 512)
    # largest traceback buffer one K1 launch may allocate
    TB_CAP_BYTES = 256 << 20

    def __init__(self, match=20, mismatch=-10, gap_open=9, gap_extend=1,
                 device="cuda"):
        self.params = (match, mismatch, gap_open, gap_extend)
        self.device = resolve_device(device)

    def _bucket(self, n):
        for b in self.BUCKETS:
            if n <= b:
                return b
        return None

    def align_many(self, pairs):
        """pairs: list of (query, ref) strings → list of cigars
        (same op/length convention as nw.nw_align)."""
        out = [None] * len(pairs)
        groups = {}
        for k, (q, r) in enumerate(pairs):
            bq = self._bucket(len(q))
            br = self._bucket(len(r))
            if bq is None or br is None or len(q) == 0 or len(r) == 0:
                out[k] = nw_align(q, r, match=self.params[0],
                                  mismatch=self.params[1],
                                  gap_open=self.params[2],
                                  gap_extend=self.params[3])[1]
            else:
                groups.setdefault((bq, br), []).append(k)
        for (Q, R), idxs in groups.items():
            per_launch = max(1, self.TB_CAP_BYTES // ((Q + 1) * (R + 1)))
            for lo in range(0, len(idxs), per_launch):
                self._align_bucket(pairs, idxs[lo : lo + per_launch], Q, R,
                                   out)
        return out

    def _align_bucket(self, pairs, idxs, Q, R, out):
        qcodes, rcodes, qlens, rlens = encode_pairs([pairs[k] for k in idxs],
                                                    Q, R)
        dev = self.device
        tb = nw_tb(torch.from_numpy(qcodes).to(dev),
                   torch.from_numpy(rcodes).to(dev), *self.params)
        T = 2 * (Q + R) + 2
        em = nw_walk(tb, torch.from_numpy(qlens), torch.from_numpy(rlens),
                     T).cpu().numpy()
        for b, k in enumerate(idxs):
            codes = em[b]
            codes = codes[codes > 0][::-1]
            walk = [("diz"[c - 1], 0, 0) for c in codes]
            out[k] = refine_diag_ops(_walk_to_cigar(walk), *pairs[k])


def _walk_to_cigar(walk):
    cigar = []
    for kind, i, j in walk:
        if kind == "d":
            op = -1  # placeholder, refined below by caller comparing codes
        elif kind == "i":
            op = 1
        else:
            op = 2
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return [(op, l) for op, l in cigar]


def refine_diag_ops(cigar, query, ref):
    """Replace diagonal placeholder ops (-1) with '='(7)/'X'(8) runs by
    comparing the actual characters."""
    out = []
    qi = ri = 0
    for op, l in cigar:
        if op == -1:
            run_op = None
            run_len = 0
            for k in range(l):
                a, b = query[qi + k], ref[ri + k]
                o = 7 if (a == b and a in "ACGT") else 8
                if o == run_op:
                    run_len += 1
                else:
                    if run_op is not None:
                        out.append((run_op, run_len))
                    run_op, run_len = o, 1
            out.append((run_op, run_len))
            qi += l
            ri += l
        else:
            out.append((op, l))
            if op == 1:
                qi += l
            else:
                ri += l
    return out
