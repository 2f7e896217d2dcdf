"""Hand-written CUDA kernels of the NW alignment path and their plain
PyTorch twins.

- K1 `nw_tb` (csrc/nw_tb.cu) replaces the Pallas kernel
  nanocaller_tpu/align/pallas_nw.py::batch_nw_tb_pallas: the batched
  affine-gap DP, returning the (B, Q+1, R+1) uint8 traceback that
  nanocaller_tpu/align/batch_nw.py::_batch_nw returns. One launch runs
  one of two kernels, chosen by shape in the source: a lane-skewed
  wavefront, or for short queries a row-by-row scan.
- K2 `nw_walk` (csrc/nw_walk.cu) replaces
  nanocaller_tpu/align/batch_nw.py::_walk_device: the traceback walk,
  returning the (B, T) int8 op stream.
- K4 `nw_cigar` (csrc/nw_cigar.cu) replaces the host walk of that
  stream in nanocaller_tpu/align/batch_nw.py::BatchAligner.align_many
  (`_walk_to_cigar` + `refine_diag_ops`): K2's op stream and the pairs'
  raw bytes in, each pair's packed (len << 4) | op runs and their count
  out, on the card.

Each wrapper takes its plain twin (`nw_tb_reference`, `nw_walk_reference`,
`nw_cigar_reference`) only for a tensor on the CPU; for a CUDA tensor it
launches its kernel (runtime/kernels.py builds the library) or raises.
"""

from __future__ import annotations

import torch

from ..runtime import kernels
from ..runtime.kernels import I, P
from ..runtime.metrics import count

NEG = -(1 << 28)


def _count_launch(k, Q, R, B):
    """The counters (runtime/metrics.py) of K1, K2 and K4: each wrapper
    adds one to `<k>.launches.<Q>x<R>` where it launches its kernel on a
    (Q, R) bucket, and the launch's pairs to `<k>.pairs.<Q>x<R>`;
    metrics.total sums a kernel's over the buckets."""
    count("%s.launches.%dx%d" % (k, Q, R))
    count("%s.pairs.%dx%d" % (k, Q, R), B)


def _check(t, name, dtype, ndim):
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if t.dim() != ndim:
        raise ValueError("%s must be %d-D, got shape %s"
                         % (name, ndim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError("%s on unsupported device %s" % (name, t.device))


# -- K1: DP traceback ---------------------------------------------------------

def nw_tb(qcodes, rcodes, match, mismatch, gap_open, gap_extend):
    """qcodes (B, Q) int8, rcodes (B, R) int8 (codes 0-3 ACGT, 4 other/pad)
    → tb (B, Q+1, R+1) uint8, bit-identical to _batch_nw's traceback."""
    _check(qcodes, "qcodes", torch.int8, 2)
    _check(rcodes, "rcodes", torch.int8, 2)
    if qcodes.device != rcodes.device or qcodes.shape[0] != rcodes.shape[0]:
        raise ValueError("qcodes/rcodes: batch or device mismatch")
    if qcodes.device.type == "cpu":
        return nw_tb_reference(qcodes, rcodes, match, mismatch, gap_open,
                               gap_extend)
    B, Q = qcodes.shape
    R = rcodes.shape[1]
    if not (1 <= R <= 1023 and Q >= 1):
        raise ValueError("nw_tb: need 1 <= R <= 1023 and Q >= 1 (Q=%d, R=%d)"
                         % (Q, R))
    tb = torch.empty((B, Q + 1, R + 1), dtype=torch.uint8,
                     device=qcodes.device)
    if B == 0:
        return tb
    launch = kernels.launch_fn("nw_tb_launch", [P, P, P] + [I] * 7 + [P])
    with torch.cuda.device(qcodes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(qcodes.data_ptr(), rcodes.data_ptr(), tb.data_ptr(), B,
                    Q, R, int(match), int(mismatch), int(gap_open),
                    int(gap_extend), stream)
    if rc != 0:
        raise RuntimeError("nw_tb launch failed: cudaError %d" % rc)
    _count_launch("k1", Q, R, B)
    return tb


def nw_tb_reference(qcodes, rcodes, match, mismatch, gap_open, gap_extend):
    """Plain PyTorch twin of K1: the row loop of _batch_nw, with
    torch.cummax for the prefix max. Same inputs and output.

    A row is eighteen whole-row ops, each written into a buffer made once
    (`out=` or in place). On the CPU each such op on a large batch is one
    parallel region of torch's intra-op pool, and every region ends at a
    barrier of all its threads, so the loop keeps the regions few."""
    B, Q = qcodes.shape
    R = rcodes.shape[1]
    dev = qcodes.device
    go, ge = int(gap_open), int(gap_extend)
    i32, u8 = torch.int32, torch.uint8
    jext = torch.arange(R + 1, dtype=i32, device=dev) * ge
    jext_go = jext - go
    # H: the previous row's scores; V: its vertical-gap scores, whose
    # column 0 stays NEG; vnew, the view V's new row is written into
    H = torch.empty((B, R + 1), dtype=i32, device=dev)
    H[:, 0] = 0
    H[:, 1:] = -(go + jext[:-1])
    V = torch.full((B, R + 1), NEG, dtype=i32, device=dev)
    vnew = V[:, 1:]
    tb = torch.empty((B, Q + 1, R + 1), dtype=u8, device=dev)
    tb[:, 0, 0] = 0
    if R >= 1:
        tb[:, 0, 1] = 2
        tb[:, 0, 2:] = 2 | 8
    if Q >= 1:
        tb[:, 1, 0] = 1
        tb[:, 2:, 0] = 1 | 4
    # a reference code >= 4 becomes a value no int8 query code takes, so
    # that q == r holds exactly where (q == r) & (q < 4) does
    rj = torch.where(rcodes < 4, rcodes.to(i32), 1 << 16)
    qc_all = qcodes.to(i32)
    sub_match = torch.tensor(match, dtype=i32, device=dev)
    sub_mismatch = torch.tensor(mismatch, dtype=i32, device=dev)
    from_z = torch.tensor(2, dtype=u8, device=dev)
    G, c, M = (torch.empty((B, R + 1), dtype=i32, device=dev)
               for _ in range(3))
    M_at = torch.empty((B, R + 1), dtype=torch.int64, device=dev)
    diag, h_go, v_ge, Z = (torch.empty((B, R), dtype=i32, device=dev)
                           for _ in range(4))
    is_match, v_ext, came_v, came_z = (
        torch.empty((B, R), dtype=torch.bool, device=dev) for _ in range(4))
    z_ext = torch.zeros((B, R), dtype=torch.bool, device=dev)
    for i in range(1, Q + 1):
        torch.eq(rj, qc_all[:, i - 1 : i], out=is_match)
        torch.where(is_match, sub_match, sub_mismatch, out=diag)
        diag += H[:, :-1]
        torch.sub(H[:, 1:], go, out=h_go)
        torch.sub(vnew, ge, out=v_ge)
        torch.gt(v_ge, h_go, out=v_ext)
        torch.maximum(h_go, v_ge, out=vnew)
        torch.gt(vnew, diag, out=came_v)
        G[:, 0] = -(go + (i - 1) * ge)
        torch.maximum(diag, vnew, out=G[:, 1:])
        torch.add(G, jext_go, out=c)
        torch.cummax(c, 1, out=(M, M_at))
        torch.sub(M[:, :-1], jext[:-1], out=Z)
        torch.gt(M[:, :-2], c[:, 1:-1], out=z_ext[:, 1:])
        torch.gt(Z, G[:, 1:], out=came_z)
        H[:, 0] = G[:, 0]
        torch.maximum(G[:, 1:], Z, out=H[:, 1:])
        # the code: 2 from Z, else 1 from V, else 0; +4 V extended; +8 Z
        row = tb[:, i, 1:]
        torch.where(came_z, from_z, came_v.view(u8), out=row)
        row.add_(v_ext.view(u8), alpha=4)
        row.add_(z_ext.view(u8), alpha=8)
    return tb


# -- K2: traceback walk -------------------------------------------------------

def nw_walk(tb, qlens, rlens, T):
    """tb (B, Q+1, R+1) uint8, qlens/rlens (B,) int32 CPU tensors → (B, T)
    int8 op codes (0 none, 1 diag, 2 ins, 3 del) in end→start order, step
    for step as _walk_device emits them. T must be ≥ 2·(Q+R)+2.

    The lengths stay on the host, where the caller builds them: they are
    range-checked there and copied to the card with the launch, so the
    check costs no device round trip."""
    _check(tb, "tb", torch.uint8, 3)
    _check(qlens, "qlens", torch.int32, 1)
    _check(rlens, "rlens", torch.int32, 1)
    B, Q1, R1 = tb.shape
    if qlens.shape[0] != B or rlens.shape[0] != B:
        raise ValueError("nw_walk: batch mismatch")
    if qlens.device.type != "cpu" or rlens.device.type != "cpu":
        raise ValueError("nw_walk: qlens and rlens must be CPU tensors")
    if T < 2 * (Q1 - 1 + R1 - 1) + 2:
        raise ValueError("nw_walk: T=%d < 2(Q+R)+2" % T)
    # the kernel would read outside the pair's matrix without a fault
    if bool(((qlens < 0) | (qlens >= Q1) | (rlens < 0) | (rlens >= R1))
            .any()):
        raise ValueError("nw_walk: need 0 <= qlens <= Q=%d and "
                         "0 <= rlens <= R=%d" % (Q1 - 1, R1 - 1))
    if tb.device.type == "cpu":
        return nw_walk_reference(tb, qlens, rlens, T)
    ops = torch.empty((B, T), dtype=torch.int8, device=tb.device)
    if B == 0:
        return ops
    # pinned, so that the copy is queued on the stream without a wait
    lens = torch.stack((qlens, rlens)).pin_memory().to(tb.device,
                                                       non_blocking=True)
    launch = kernels.launch_fn("nw_walk_launch", [P, P, P] + [I] * 4 + [P])
    with torch.cuda.device(tb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(tb.data_ptr(), lens.data_ptr(), ops.data_ptr(), B,
                    Q1 - 1, R1 - 1, int(T), stream)
    if rc != 0:
        raise RuntimeError("nw_walk launch failed: cudaError %d" % rc)
    _count_launch("k2", Q1 - 1, R1 - 1, B)
    return ops


def nw_walk_reference(tb, qlens, rlens, T):
    """Plain PyTorch twin of K2: _walk_device's step machine vectorised
    over the batch, stopping once every walk has reached (0, 0) (the
    remaining steps emit 0)."""
    B, Q1, R1 = tb.shape
    dev = tb.device
    flat = tb.reshape(B, -1)
    i = qlens.to(torch.int64).clone()
    j = rlens.to(torch.int64).clone()
    state = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = torch.zeros((B, T), dtype=torch.int8, device=dev)
    for s in range(T):
        active = (i > 0) | (j > 0)
        if not bool(active.any()):
            break
        cell = flat.gather(1, (i * R1 + j)[:, None])[:, 0].to(torch.int64)
        at0 = (state == 0) & active
        force1 = at0 & (j == 0)
        force2 = at0 & (i == 0) & (j > 0)
        inner = at0 & (i > 0) & (j > 0)
        src = cell & 3
        diag = inner & (src == 0)
        tost = inner & (src != 0)
        s1 = (state == 1) & active
        s2 = (state == 2) & active
        ops[:, s] = torch.where(diag, 1, torch.where(
            s1, 2, torch.where(s2, 3, 0))).to(torch.int8)
        i = i - (diag | s1).to(torch.int64)
        j = j - (diag | s2).to(torch.int64)
        state = torch.where(force1, 1, torch.where(force2, 2, torch.where(
            tost, src, torch.where(s1 & ((cell & 4) == 0), 0, torch.where(
                s2 & ((cell & 8) == 0), 0, state)))))
    return ops


# -- K4: op stream to packed cigar runs ---------------------------------------

def nw_cigar(ops, qraw, rraw):
    """ops (B, T) int8 (K2's op stream), qraw (B, Q) and rraw (B, R) uint8
    (the pairs' bytes, zero-padded) → (runs (B, Q+R) int32, counts (B,)
    int32): row b's first counts[b] entries are its cigar, the maximal
    runs of '=' 7 / 'X' 8 / 'I' 1 / 'D' 2 packed (len << 4) | op in
    forward order, as refine_diag_ops(_walk_to_cigar(...)) gives them; a
    diagonal step is '=' only for equal bytes in "ACGT". The rest of a row
    is unspecified. counts[b] is -1 for a stream that reads past Q or R or
    holds a code outside 0-3; the caller raises on it."""
    _check(ops, "ops", torch.int8, 2)
    _check(qraw, "qraw", torch.uint8, 2)
    _check(rraw, "rraw", torch.uint8, 2)
    B, T = ops.shape
    Q, R = qraw.shape[1], rraw.shape[1]
    if qraw.shape[0] != B or rraw.shape[0] != B or not (
            ops.device == qraw.device == rraw.device):
        raise ValueError("nw_cigar: batch or device mismatch")
    if Q < 1 or R < 1:
        raise ValueError("nw_cigar: need Q >= 1 and R >= 1 (Q=%d, R=%d)"
                         % (Q, R))
    if ops.device.type == "cpu":
        return nw_cigar_reference(ops, qraw, rraw)
    runs = torch.empty((B, Q + R), dtype=torch.int32, device=ops.device)
    counts = torch.empty(B, dtype=torch.int32, device=ops.device)
    if B == 0:
        return runs, counts
    launch = kernels.launch_fn("nw_cigar_launch", [P] * 5 + [I] * 4 + [P])
    with torch.cuda.device(ops.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(ops.data_ptr(), qraw.data_ptr(), rraw.data_ptr(),
                    runs.data_ptr(), counts.data_ptr(), B, T, Q, R, stream)
    if rc != 0:
        raise RuntimeError("nw_cigar launch failed: cudaError %d" % rc)
    _count_launch("k4", Q, R, B)
    return runs, counts


# "ACGT" bytes: the only ones a diagonal step may call '='
_ACGT = torch.zeros(256, dtype=torch.bool)
_ACGT[[ord(c) for c in "ACGT"]] = True


def nw_cigar_reference(ops, qraw, rraw):
    """Plain PyTorch twin of K4, vectorised over the batch: the non-zero
    ops moved to the front of each row in start-to-end order, the query
    and reference index of each step by prefix sums, the op of each step,
    and its maximal runs by a scatter-add over run ids. Same inputs and
    output; the rows' unused entries are 0."""
    B, T = ops.shape
    Q, R = qraw.shape[1], rraw.shape[1]
    dev = ops.device
    i64 = torch.int64
    o = ops.flip(1).to(i64)
    # the non-zero steps first, in order (a stable sort on "is zero")
    o = o.gather(1, torch.sort((o == 0).to(torch.int8), dim=1,
                               stable=True).indices)
    valid = o != 0
    useq = (o == 1) | (o == 2)
    user = (o == 1) | (o == 3)
    bad = ((o < 0) | (o > 3)).any(1) | (useq.sum(1) > Q) | \
        (user.sum(1) > R)
    qi = (torch.cumsum(useq, 1) - useq.to(i64)).clamp(max=Q - 1)
    ri = (torch.cumsum(user, 1) - user.to(i64)).clamp(max=R - 1)
    a = qraw.to(i64).gather(1, qi)
    e = rraw.to(i64).gather(1, ri)
    same = (a == e) & _ACGT.to(dev)[a]
    op = torch.where(o == 1, torch.where(same, 7, 8),
                     torch.where(o == 2, 1, 2))
    op = torch.where(valid, op, 0)
    prev = torch.cat([torch.zeros((B, 1), dtype=i64, device=dev),
                      op[:, :-1]], 1)
    start = valid & (op != prev)
    counts = start.sum(1)
    rid = (torch.cumsum(start, 1) - 1).clamp(min=0)
    lens = torch.zeros((B, T), dtype=i64, device=dev).scatter_add_(
        1, rid, valid.to(i64))
    ops_of = torch.zeros((B, T), dtype=i64, device=dev).scatter_add_(
        1, rid, torch.where(start, op, 0))
    runs = ((lens << 4) | ops_of)[:, : Q + R].to(torch.int32)
    counts = torch.where(bad, -1, counts).to(torch.int32)
    return runs, counts
