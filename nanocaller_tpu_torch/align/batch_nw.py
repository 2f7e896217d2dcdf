"""Batched affine NW on the device: BatchAligner over kernels K1, K2, K4.

The port of nanocaller_tpu/align/batch_nw.py::BatchAligner. Thousands of
(query, ref) pairs are padded into (Q, R) buckets; K1 (`nw_tb`) runs the
DP of a bucket in one launch, K2 (`nw_walk`) walks every traceback on
the device, and K4 (`nw_cigar`) turns each pair's op stream into its
packed cigar runs there too, from the pairs' raw bytes. Only the run
counts and the runs, cut at the largest count, come back to the host,
through pinned memory: neither the traceback nor K2's (B, T) op stream
is copied. Cigars are identical to nw.nw_align's (the tests assert it;
a diagonal step is '=' only for equal bytes in "ACGT", as
refine_diag_ops decides).

The DP of cell (i, j) reads only cells (≤i, ≤j), so it does not depend
on padding: the port drops the TPU's lane padding of R+1 to a multiple
of 128. A bucket's pairs are split so that no launch's traceback buffer
exceeds TB_CAP_BYTES.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..runtime.device import resolve_device, to_host
from .nw import _CHAR_CODE, nw_align, pack_cigar
from .nw_kernels import nw_cigar, nw_tb, nw_walk


def _traceback_matrix(tb, qlen, rlen):
    """Host traceback over one uint8 matrix (same walk as nw.py); the
    host oracle of K2, called by tests only."""
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


def pad_bytes(strings, width):
    """ASCII strings → their bytes in an (n, width) uint8 array, zero
    padded, and their (n,) int32 lengths: one join, one scatter by
    offsets."""
    n = len(strings)
    lens = np.fromiter(map(len, strings), np.int64, n)
    if n and int(lens.max()) > width:
        raise ValueError("pad_bytes: a string of %d bytes exceeds the "
                         "width %d" % (int(lens.max()), width))
    out = np.zeros((n, width), np.uint8)
    total = int(lens.sum())
    if total:
        cat = np.frombuffer("".join(strings).encode("ascii"), np.uint8)
        starts = np.cumsum(lens) - lens
        out.reshape(-1)[np.arange(total) + np.repeat(
            np.arange(n) * width - starts, lens)] = cat
    return out, lens.astype(np.int32)


def encode_pairs(pairs, Q, R):
    """(query, ref) strings → qcodes (n, Q) int8 and rcodes (n, R) int8
    (0-3 ACGT in either case, 4 other and pad) and their (n,) int32
    lengths: one bucket's inputs to K1 and K2."""
    qraw, qlens = pad_bytes([q for q, _ in pairs], Q)
    rraw, rlens = pad_bytes([r for _, r in pairs], R)
    return _CHAR_CODE[qraw], _CHAR_CODE[rraw], qlens, rlens


class BatchAligner:
    """Pads string pairs into fixed (Q, R) buckets, runs K1, K2 and K4 on
    `device` and returns cigars identical to nw.nw_align's. On
    device="cpu" the kernels' plain twins run."""

    BUCKETS = (64, 128, 192, 256, 320, 512)
    # largest traceback buffer one K1 launch may allocate
    TB_CAP_BYTES = 256 << 20

    def __init__(self, match=20, mismatch=-10, gap_open=9, gap_extend=1,
                 device="cuda"):
        self.params = (match, mismatch, gap_open, gap_extend)
        self.device = resolve_device(device)
        # seconds spent by align_many: "encode" (bucketing, the byte and
        # code arrays), "device" (K1/K2/K4 launches, the copies back, the
        # split into cigars)
        self.timers = {"encode": 0.0, "device": 0.0}

    def _bucket(self, n):
        for b in self.BUCKETS:
            if n <= b:
                return b
        return None

    def align_many(self, pairs, packed=False):
        """pairs: list of (query, ref) strings → one cigar a pair (same
        op/length convention as nw.nw_align): [(op, len)] lists, or with
        packed=True read-only uint32 (len << 4) | op run arrays, the wire
        msa_project_native takes. Pairs outside the buckets or with an
        empty side go to nw_align."""
        t0 = time.perf_counter()
        out = [None] * len(pairs)
        groups = {}
        for k, (q, r) in enumerate(pairs):
            bq = self._bucket(len(q))
            br = self._bucket(len(r))
            if bq is None or br is None or len(q) == 0 or len(r) == 0:
                cig = nw_align(q, r, match=self.params[0],
                               mismatch=self.params[1],
                               gap_open=self.params[2],
                               gap_extend=self.params[3])[1]
                out[k] = pack_cigar(cig) if packed else cig
            else:
                groups.setdefault((bq, br), []).append(k)
        self.timers["encode"] += time.perf_counter() - t0
        # queue every launch, then wait once for the counts and once for
        # the runs
        queued = []
        for (Q, R), idxs in groups.items():
            per_launch = max(1, self.TB_CAP_BYTES // ((Q + 1) * (R + 1)))
            for lo in range(0, len(idxs), per_launch):
                sub = idxs[lo : lo + per_launch]
                queued.append((sub, *self._launch(pairs, sub, Q, R)))
        t1 = time.perf_counter()
        self._sync()
        cut = []
        for sub, runs, counts in queued:
            counts = counts.numpy()
            if (counts < 0).any():
                raise RuntimeError("nw_cigar: an op stream reads past its "
                                   "pair's bytes")
            host, _done = to_host(runs[:, : int(counts.max())])
            cut.append((sub, counts, host))
        self._sync()
        for sub, counts, runs in cut:
            h = runs.numpy().view(np.uint32).copy()
            h.flags.writeable = False
            if packed:
                for b, k in enumerate(sub):
                    out[k] = h[b, : counts[b]]
            else:
                ops_l, lens_l = (h & 0xF).tolist(), (h >> 4).tolist()
                for b, k in enumerate(sub):
                    n = counts[b]
                    out[k] = list(zip(ops_l[b][:n], lens_l[b][:n]))
        self.timers["device"] += time.perf_counter() - t1
        return out

    def _launch(self, pairs, idxs, Q, R):
        """Encode one launch's pairs and queue K1, K2 and K4; returns the
        runs on the device and the counts' queued host copy."""
        t0 = time.perf_counter()
        qraw, qlens = pad_bytes([pairs[k][0] for k in idxs], Q)
        rraw, rlens = pad_bytes([pairs[k][1] for k in idxs], R)
        qcodes, rcodes = _CHAR_CODE[qraw], _CHAR_CODE[rraw]
        t1 = time.perf_counter()
        self.timers["encode"] += t1 - t0
        dev = self.device
        up = lambda a: torch.from_numpy(a).to(dev)
        tb = nw_tb(up(qcodes), up(rcodes), *self.params)
        ops = nw_walk(tb, torch.from_numpy(qlens), torch.from_numpy(rlens),
                      2 * (Q + R) + 2)
        runs, counts = nw_cigar(ops, up(qraw), up(rraw))
        self.timers["device"] += time.perf_counter() - t1
        return runs, to_host(counts)[0]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()


def _walk_to_cigar(walk):
    """A walk's ops merged into runs, diagonal runs as placeholders (-1);
    with refine_diag_ops, the host oracle of K4, called by tests only."""
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
