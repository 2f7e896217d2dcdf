"""The plain twins of K4 (nw_cigar_reference) and K5
(snp_dense_pileup_reference), the kernels' oracles on the card, against
the JAX package on the edge inputs where the kernels' designs branch
(nanocaller_tpu_torch.sim.cigar_edge_case and dense_edge_case), exactly:

- K4: hand-built op streams whose last non-zero step falls at the first
  or last byte of a 16-, 32- or 128-byte block, all-zero rows, bad
  streams (a code outside 0-3, or more query or reference bytes than the
  pair has) with the fault in the first, a middle or the last chunk of
  32 row positions, one pair, batches one over the kernel's changes of
  warps a pair and of waves, and every bucket pair the main path,
  --preset ccs and training launch; raw bytes with N and lowercase.
  Each valid row's runs against JAX's host walk (`_walk_to_cigar` then
  `refine_diag_ops`), packed (len << 4) | op; each bad row's count -1,
  and a row is bad exactly where its stream holds a code outside 0-3 or
  consumes past Q or R.
- K5: R in {0, 1, 15, 17, 224, 225, 255, 256, 300} at B = 133 (prefix
  and scattered read masks), one row at R = 45 and 300, and columns
  whose count is R: x against assemble_matrices_np times the coverage
  scale, ref against the centre-ref one-hot.

The counts are integers and x is one float32 rounding of the same
product on both sides, so every comparison is exact."""

import types

import numpy as np
import pytest
import torch

from nanocaller_tpu.align.batch_nw import _walk_to_cigar, refine_diag_ops
from nanocaller_tpu.pileup.snp_features import assemble_matrices_np
from nanocaller_tpu_torch.align import nw_kernels as K
from nanocaller_tpu_torch.pileup import snp_dense as K5
from nanocaller_tpu_torch.runtime.metrics import total
from nanocaller_tpu_torch.sim import (CIGAR_EDGE_LABELS, DENSE_EDGE_LABELS,
                                      cigar_edge_case, dense_edge_case)

from torch_threads import _torch_threads  # noqa: F401 (autouse)


def _bad_rows(ops, Q, R):
    """Rows whose stream holds a code outside 0-3 or consumes more than Q
    query or R reference bytes, by counting."""
    o = ops.astype(np.int64)
    useq = ((o == 1) | (o == 2)).sum(1)
    user = ((o == 1) | (o == 3)).sum(1)
    return ((o < 0) | (o > 3)).any(1) | (useq > Q) | (user > R)


def _host_cigar(row, qraw, rraw):
    """JAX's host walk of one op row, packed: the non-zero codes in
    start-to-end order through _walk_to_cigar and refine_diag_ops."""
    codes = row[row > 0][::-1]
    walk = [("diz"[c - 1], 0, 0) for c in codes]
    cigar = refine_diag_ops(_walk_to_cigar(walk), bytes(qraw).decode(),
                            bytes(rraw).decode())
    return [(n << 4) | op for op, n in cigar]


@pytest.mark.parametrize("label", CIGAR_EDGE_LABELS)
def test_cigar_twin_matches_host_walk(label):
    ops, qraw, rraw = cigar_edge_case(label)
    B, T = ops.shape
    Q, R = qraw.shape[1], rraw.shape[1]
    assert T == 2 * (Q + R) + 2
    before = total("k4.launches")
    runs, counts = K.nw_cigar(torch.from_numpy(ops), torch.from_numpy(qraw),
                              torch.from_numpy(rraw))
    assert total("k4.launches") == before  # the twin, not a launch
    runs, counts = runs.numpy(), counts.numpy()
    bad = _bad_rows(ops, Q, R)
    np.testing.assert_array_equal(counts < 0, bad)
    assert set(counts[bad].tolist()) <= {-1}
    for b in np.flatnonzero(~bad):
        want = _host_cigar(ops[b], qraw[b], rraw[b])
        assert runs[b, :counts[b]].tolist() == want, (label, b)
    if label.startswith("bad"):
        assert bad.sum() >= 9 and (~bad).sum() >= 9
    if label == "boundaries":
        assert (counts == 0).sum() >= 10
    # runs longer than 15 steps exercise the packing's length field
    if label == "boundaries" or label.startswith("pairs_"):
        assert int((runs[~bad] >> 4).max()) > 15


def test_cigar_edges_hit_their_boundaries():
    """The edge inputs are what their labels say: in `boundaries` the last
    non-zero steps fall on the first and the last byte of 16-, 32- and
    128-byte blocks of the op array and at the row's end; the bad
    streams' faults lie in the first, a middle and the last chunk of 32
    row positions from the top non-zero step."""
    ops, qraw, rraw = cigar_edge_case("boundaries")
    B, T = ops.shape
    nz = ops != 0
    h = np.where(nz.any(1), T - 1 - np.argmax(nz[:, ::-1], 1), -1)
    at = np.arange(B) * T + h
    for block in (16, 32, 128):
        assert ((at % block == 0) & (h >= 0)).any()
        assert ((at % block == block - 1) & (h >= 0)).any()
    assert (h == T - 1).any() and (h == -1).any() and (h == 0).any()
    for label in ("bad", "bad_small"):
        ops, qraw, rraw = cigar_edge_case(label)
        Q, R = qraw.shape[1], rraw.shape[1]
        chunks = set()
        for b in np.flatnonzero(_bad_rows(ops, Q, R)):
            row = ops[b].astype(np.int64)
            top = int(np.flatnonzero(row)[-1])
            pos = np.flatnonzero(row)[::-1]  # walk order
            q = np.cumsum((row[pos] == 1) | (row[pos] == 2))
            r = np.cumsum((row[pos] == 1) | (row[pos] == 3))
            fault = np.flatnonzero((row[pos] < 0) | (row[pos] > 3) |
                                   (q > Q) | (r > R))[0]
            last = top // 32
            k = (top - int(pos[fault])) // 32
            chunks.add("first" if k == 0 else "last" if k == last
                       else "middle")
        assert chunks == ({"first", "middle", "last"} if label == "bad"
                          else {"first", "last"})


@pytest.mark.parametrize("label", DENSE_EDGE_LABELS)
def test_dense_twin_matches_assembly(label):
    codes, mask, col_ref, col_valid, center_ref, norm = \
        dense_edge_case(label)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    before = total("k5.launches")
    x, ref = K5.snp_dense_pileup(t(codes), t(mask), t(col_ref),
                                 t(col_valid), t(center_ref), t(norm))
    assert total("k5.launches") == before
    batch = types.SimpleNamespace(codes=codes, read_mask=mask,
                                  col_ref=col_ref, col_valid=col_valid,
                                  center_ref=center_ref)
    want = assemble_matrices_np(batch)
    want[:, 1:, :, :4] *= norm[:, None, None, None]
    np.testing.assert_array_equal(x.numpy(), want)
    np.testing.assert_array_equal(
        ref.numpy(), np.eye(5, dtype=np.float32)[center_ref][:, :4])
    R = codes.shape[1]
    # the counts behind x: with a read mask that is not a prefix in a
    # third of the rows, and one count equal to R in every full_column row
    counts = np.rint(np.abs(want[:, 1:, :, :4]) /
                     norm[:, None, None, None]).astype(np.int64)
    assert counts.max() <= R
    if label == "full_column":
        assert (counts.reshape(len(codes), -1).max(1) == R).all()
