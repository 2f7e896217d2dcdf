"""K3 `snp_pileup`: the SNP group kernel from an observation payload to
the CNN's input, its plain PyTorch twin, and the payload's copies to the
device.

The hand-written CUDA kernel (csrc/snp_pileup.cu, built with the other
kernels into the library of runtime/kernels.py) replaces the XLA-jitted body of
nanocaller_tpu/snp_caller.py's group kernel up to the CNN: the band-quota
neighbour selection clamped to each member's window
(`_device_select_neighbors_clamped`), the covering-read list
(`_rid_matrix` over the interval and hole test), the table-free cell
codes (`_group_cell_codes`) and the pileup assembly of
`_snp_forward_dense` (one-hot einsum, ref channel, flip, coverage scale).
One launch takes a cohort of candidate rows against one group payload and
writes the (B, 5, 41, 5) float32 NHWC tensor the SNP CNN takes, the
selected column sites (B, 41) and the centre-ref one-hot (B, 4).

The same kernel serves a single chunk's payload (SnpChunkFeatures, the
per-chunk path): `chunk_wire` lays it out as a group wire, and the
chunk's rows run with their windows clamped to the whole neighbour
array, [0, M). That is the JAX package's per-chunk device path
(_build_obs_tables_impl + _rid_matrix + _device_select_neighbors +
_gather_forward_impl, snp_caller.py:180-414) without its dense site x
read table: at full clamps the clamped selection is the unclamped one,
and K3 counts every covering read of a normal row, which _rid_matrix
lists whole because its R is at least every normal row's depth.

`snp_pileup` takes its twin `snp_pileup_reference` only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.

Counters (runtime/metrics.py): `k3.launches.group` and
`k3.launches.chunk` (launches by the kind of wire), `k3.rows` (the rows
those launches built); `to_device` counts the SNP path's host-to-device
copies (`snp.h2d_bytes`, `snp.blocking_copies`).
Spans: `_wire` records its host layout as `snp.wire` and its copies as
`snp.copy_in`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..runtime import kernels
from ..runtime.kernels import I, P
from ..runtime.metrics import count, span
from .snp_features import BAND_SCHEDULES, CENTER, WIDTH

# rows of the band table a side: the most bands any schedule has
MAX_BANDS = 7


def to_device(host, device):
    """Host arrays {name: array} → {name: tensor on `device`}, a copy each
    that is not empty (PyTorch copies nothing for an empty one). A copy
    from pageable host memory without non_blocking makes the host wait
    for the device's stream, so each counts in snp.blocking_copies, and
    its bytes in snp.h2d_bytes (counted on every device, the CPU's
    included)."""
    arrays = {k: np.ascontiguousarray(a) for k, a in host.items()}
    count("snp.blocking_copies", sum(1 for a in arrays.values() if a.size))
    count("snp.h2d_bytes", sum(a.nbytes for a in arrays.values()))
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


def band_table(seq_type):
    """BAND_SCHEDULES[seq_type] as an int32 (2, MAX_BANDS, 4) table: per
    side (left, right) rows of (lo_off, hi_off, k, take), take 0 for
    "first" and 1 for "last", in the schedule's order; unused rows are
    zero (k = 0 selects nothing). Each side's k sum to at most 20, so its
    columns fit beside the centre, and the bands ascend without overlap,
    left ones before the candidate and right ones after it, so that the
    selected neighbour indices ascend from column to column."""
    sched = BAND_SCHEDULES[seq_type]
    table = np.zeros((2, MAX_BANDS, 4), np.int32)
    for i, side in enumerate(("left", "right")):
        bands = sched[side]
        ends = [e for lo_off, hi_off, _, _ in bands for e in (lo_off, hi_off)]
        if len(bands) > MAX_BANDS or sum(b[2] for b in bands) > CENTER \
                or ends != sorted(ends) \
                or not (ends[-1] <= 0 if side == "left" else ends[0] > 0):
            raise ValueError("band schedule %r does not fit the table"
                             % seq_type)
        for j, (lo_off, hi_off, k, take) in enumerate(bands):
            table[i, j] = (lo_off, hi_off, k, take == "last")
    return table


@dataclass
class PileupWire:
    """One group's payload on a device (SnpGroupFeatures' arrays, int32
    indices and int8/uint8 codes), with the reads' start order and the
    neighbour arrays:

    read_lo, read_hi, span_start  int32 (N); span_start is the exclusive
                                  cumsum of max(hi - lo + 1, 0)
    site_ref, site_major, site_minor  int8 (S + 1); trash row S holds 4
    minor_bits                    uint8 (T)
    exc_indptr, hole_indptr       int32 (S + 2), CSR rows over the sites
    exc_rid, exc_code             int32 / int8 (E)
    hole_rid                      int32 (H)
    order                         int32 (N), the read ids sorted by
                                  (read_lo, id)
    win_lo, win_hi                int32 (S + 1), each site's read window
                                  [win_lo, win_hi) of that order
                                  (read_windows)
    nbr_pos, nbr_union            int32 (M), sorted neighbour positions
                                  and their union-site indices (which
                                  do not decrease either)
    bands                         int32 (2, MAX_BANDS, 4), band_table
    kind                          "group" (group_wire) or "chunk"
                                  (chunk_wire); not a kernel argument
    """

    read_lo: torch.Tensor
    read_hi: torch.Tensor
    span_start: torch.Tensor
    site_ref: torch.Tensor
    site_major: torch.Tensor
    site_minor: torch.Tensor
    minor_bits: torch.Tensor
    exc_indptr: torch.Tensor
    exc_rid: torch.Tensor
    exc_code: torch.Tensor
    hole_indptr: torch.Tensor
    hole_rid: torch.Tensor
    order: torch.Tensor
    win_lo: torch.Tensor
    win_hi: torch.Tensor
    nbr_pos: torch.Tensor
    nbr_union: torch.Tensor
    bands: torch.Tensor
    kind: str = "group"

    @property
    def n_reads(self):
        return self.read_lo.shape[0]

    @property
    def n_sites(self):
        return self.site_ref.shape[0] - 1

    @property
    def n_nbrs(self):
        return self.nbr_pos.shape[0]

    def tensors(self):
        """The tensor fields in declaration order, the kernel's argument
        order."""
        return tuple(getattr(self, f.name) for f in fields(self)
                     if f.name != "kind")


def group_wire(gf, device, arg=None):
    """A group payload's host arrays (SnpGroupFeatures, or any object with
    its read_lo, read_hi, site_*, minor_bits, exc_*, hole_*, nbr_pos,
    nbr_union and seq_type fields) → a PileupWire on `device`: the trash
    site row, the CSR row pointers over S + 2 rows and the span offsets,
    as the JAX package's infer_snp_group and _group_cell_codes derive
    them; the reads' start order and each site's read window; the band
    table of gf.seq_type.
    Raises ValueError, before any copy, if nbr_pos or nbr_union is not
    sorted (K3 counts a read's cells over the columns it reaches, which
    needs the columns' sites in order). `arg` tags the spans (the
    group's number)."""
    return _wire(gf, None, gf.exc_rid, gf.exc_code, device, "group", arg)


def chunk_wire(feats, device):
    """A chunk's payload (SnpChunkFeatures) → a PileupWire on `device`, as
    group_wire lays out a group's: the exceptions' site CSR over S + 1
    rows gains the trash row S (empty), and each (rid << 3) | code entry
    splits into exc_rid and exc_code. K3 takes its rows with lo_c = 0 and
    hi_c = M."""
    packed = np.asarray(feats.exc_packed, np.int64)
    indptr = np.asarray(feats.exc_indptr, np.int32)
    return _wire(feats, np.append(indptr, indptr[-1]).astype(np.int32),
                 packed >> 3, packed & 7, device, "chunk")


def _wire(gf, exc_indptr, exc_rid, exc_code, device, kind, arg=None):
    """The wire's host layout (span snp.wire), then its 18 copies to
    `device` (span snp.copy_in), both tagged with `arg`. exc_indptr None:
    the CSR row pointers of gf.exc_site (a group's exceptions)."""
    with span("snp.wire", arg):
        S = len(gf.site_ref)
        i32 = np.int32
        nbr_pos = np.asarray(gf.nbr_pos, i32)
        nbr_union = np.asarray(gf.nbr_union, i32)
        for name, a in (("nbr_pos", nbr_pos), ("nbr_union", nbr_union)):
            if len(a) > 1 and (np.diff(a) < 0).any():
                raise ValueError("%s_wire: %s must be sorted" % (kind, name))
        trash = np.full(1, 4, np.int8)
        read_lo = np.asarray(gf.read_lo, i32)
        read_hi = np.asarray(gf.read_hi, i32)
        spans = np.maximum(read_hi.astype(np.int64) - read_lo + 1, 0)
        span_start = np.zeros(len(spans), i32)
        if len(spans) > 1:
            span_start[1:] = np.cumsum(spans[:-1])
        order, win_lo, win_hi = read_windows(read_lo, read_hi, S)
        if exc_indptr is None:
            exc_indptr = _prefix_count(gf.exc_site, S + 2, strict=True)
        site = lambda a: np.concatenate([np.asarray(a, np.int8), trash])
        host = dict(
            read_lo=read_lo, read_hi=read_hi, span_start=span_start,
            site_ref=site(gf.site_ref), site_major=site(gf.site_major),
            site_minor=site(gf.site_minor),
            minor_bits=np.asarray(gf.minor_bits, np.uint8),
            exc_indptr=exc_indptr, exc_rid=np.asarray(exc_rid, i32),
            exc_code=np.asarray(exc_code, np.int8),
            hole_indptr=_prefix_count(gf.hole_site, S + 2, strict=True),
            hole_rid=np.asarray(gf.hole_rid, i32),
            order=order, win_lo=win_lo, win_hi=win_hi,
            nbr_pos=nbr_pos, nbr_union=nbr_union,
            bands=band_table(gf.seq_type))
    with span("snp.copy_in", arg):
        return PileupWire(**to_device(host, device), kind=kind)


def site_depth(gf):
    """Covering reads of each union site, from a group payload's host
    arrays (SnpGroupFeatures' field names): the reads with
    read_lo <= s <= read_hi, less the holes at s. int64 (S,)."""
    S = len(gf.site_ref)
    lo = np.asarray(gf.read_lo, np.int64)
    hi = np.asarray(gf.read_hi, np.int64)
    live = lo <= hi
    starts = np.bincount(lo[live], minlength=S + 1)
    ends = np.bincount(hi[live] + 1, minlength=S + 1)
    holes = np.bincount(np.asarray(gf.hole_site, np.int64), minlength=S)
    return np.cumsum(starts - ends)[:S] - holes[:S]


def _prefix_count(keys, n, strict):
    """For every row r in [0, n), how many keys are below r (strict) or
    at or below it: for sorted keys what np.searchsorted(keys,
    np.arange(n), "left" or "right") gives, by one bincount and one cumsum
    over the rows in place of a binary search a row. The keys may come in
    any order and lie anywhere: one below 0 counts in every row, one past
    the last row in none. int32 (n,)."""
    idx = np.clip(keys, -1, n - 1) if strict else np.clip(keys, 0, n)
    if strict:
        idx += 1
    return np.cumsum(np.bincount(idx, minlength=n + 1)[:n], dtype=np.int32)


def read_windows(read_lo, read_hi, S):
    """The reads' start order and, for every site s in [0, S], the window
    [k0, k1) of that order that holds every read covering s:
    order sorts the read ids by (read_lo, id); k1 counts the reads
    starting at or before s, k0 the reads of that order before the
    running max of their read_hi reaches s (before k0 every read ends
    before s), both by _prefix_count over the site axis. Exact whatever
    the reads' id order; the window may also hold reads that do not cover
    s (one long read widens every window after its start), and is empty
    where k0 >= k1 (site S, the trash site, is covered by no read). int32
    arrays (N,), (S + 1,), (S + 1,)."""
    read_lo = np.asarray(read_lo, np.int32)
    read_hi = np.asarray(read_hi, np.int32)
    order = np.argsort(read_lo, kind="stable").astype(np.int32)
    hi_max = np.maximum.accumulate(read_hi[order]) if len(order) \
        else np.zeros(0, np.int32)
    return (order, _prefix_count(hi_max, S + 1, strict=True),
            _prefix_count(read_lo, S + 1, strict=False))


_WIRE_DTYPES = {
    "read_lo": torch.int32, "read_hi": torch.int32, "span_start": torch.int32,
    "site_ref": torch.int8, "site_major": torch.int8, "site_minor": torch.int8,
    "minor_bits": torch.uint8, "exc_indptr": torch.int32,
    "exc_rid": torch.int32, "exc_code": torch.int8,
    "hole_indptr": torch.int32, "hole_rid": torch.int32,
    "order": torch.int32, "win_lo": torch.int32,
    "win_hi": torch.int32, "nbr_pos": torch.int32,
    "nbr_union": torch.int32, "bands": torch.int32}


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError("%s must be a tensor" % name)
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s must have shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))


def _check_inputs(wire, cand_site, cand_pos, lo_c, hi_c, norm, deep_rids,
                  n_valid):
    dev = cand_site.device if isinstance(cand_site, torch.Tensor) else None
    if dev is None or dev.type not in ("cpu", "cuda"):
        raise ValueError("cand_site must be a CPU or CUDA tensor")
    N, S, E, M = wire.n_reads, wire.n_sites, wire.exc_rid.shape[0], \
        wire.n_nbrs
    shapes = dict(
        read_lo=(N,), read_hi=(N,), span_start=(N,), site_ref=(S + 1,),
        site_major=(S + 1,), site_minor=(S + 1,),
        minor_bits=(wire.minor_bits.shape[0],), exc_indptr=(S + 2,),
        exc_rid=(E,), exc_code=(E,), hole_indptr=(S + 2,),
        hole_rid=(wire.hole_rid.shape[0],), order=(N,), win_lo=(S + 1,),
        win_hi=(S + 1,), nbr_pos=(M,), nbr_union=(M,),
        bands=(2, MAX_BANDS, 4))
    for name, dtype in _WIRE_DTYPES.items():
        _check(getattr(wire, name), name, dtype, shapes[name], dev)
    B = cand_site.shape[0] if cand_site.dim() == 1 else -1
    for name, t in (("cand_site", cand_site), ("cand_pos", cand_pos),
                    ("lo_c", lo_c), ("hi_c", hi_c)):
        _check(t, name, torch.int32, (B,), dev)
    _check(norm, "norm", torch.float32, (B,), dev)
    if (deep_rids is None) != (n_valid is None):
        raise ValueError("deep_rids and n_valid go together")
    if deep_rids is not None:
        D = deep_rids.shape[1] if deep_rids.dim() == 2 else -1
        _check(deep_rids, "deep_rids", torch.int32, (B, D), dev)
        _check(n_valid, "n_valid", torch.int32, (B,), dev)
    if S < 1 and B > 0:
        raise ValueError("snp_pileup: a payload without sites has no rows")
    return B


def snp_pileup(wire, cand_site, cand_pos, lo_c, hi_c, norm, deep_rids=None,
               n_valid=None):
    """Pileups of B candidate rows against one payload.

    wire: PileupWire (group_wire or chunk_wire); cand_site (B,) int32
    union-site index; cand_pos (B,) int32 position; lo_c, hi_c (B,)
    int32 the member's window [lo_c, hi_c) of the neighbour arrays
    ([0, M) on a chunk wire); norm (B,) float32 coverage scale; for deep
    rows deep_rids (B, D) int32 explicit read ids and n_valid (B,) int32
    (the first n_valid count).
    → (x, soc, ref): x (B, 5, 41, 5) float32, NHWC: row 0 the columns'
    ref one-hot, rows 1-4 the signed, scaled counts of the reads with
    centre base A/G/T/C and the ref channel; soc (B, 41) int32 the union
    site of each column (−1 padding, the centre column = cand_site); ref
    (B, 4) float32 the one-hot of the candidate's ref base (all zero for
    N). Normal rows count every covering read of the centre site (the
    caller keeps them within maxcov: see snp_caller.pileup_cohorts)."""
    B = _check_inputs(wire, cand_site, cand_pos, lo_c, hi_c, norm,
                      deep_rids, n_valid)
    if cand_site.device.type == "cpu":
        return snp_pileup_reference(wire, cand_site, cand_pos, lo_c, hi_c,
                                    norm, deep_rids, n_valid)
    dev = cand_site.device
    out = torch.empty((B, 5, WIDTH, 5), dtype=torch.float32, device=dev)
    soc = torch.empty((B, WIDTH), dtype=torch.int32, device=dev)
    ref = torch.empty((B, 4), dtype=torch.float32, device=dev)
    if B == 0:
        return out, soc, ref
    # the wire's 18 arrays, N S T M, the rows' 7 arrays, deep_w B, the
    # three outputs and the stream
    launch = kernels.launch_fn("snp_pileup_launch", [P] * 18 + [I] * 4
                               + [P] * 7 + [I, I] + [P] * 4)
    ptr = lambda t: t.data_ptr() if t is not None and t.numel() else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            *[ptr(t) for t in wire.tensors()], wire.n_reads, wire.n_sites,
            wire.minor_bits.shape[0], wire.n_nbrs, ptr(cand_site),
            ptr(cand_pos), ptr(lo_c), ptr(hi_c), ptr(norm), ptr(deep_rids),
            ptr(n_valid), 0 if deep_rids is None else deep_rids.shape[1], B,
            out.data_ptr(), soc.data_ptr(), ref.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("snp_pileup launch failed: cudaError %d" % rc)
    count("k3.launches." + wire.kind)
    count("k3.rows", B)
    return out, soc, ref


def select_neighbors_clamped(cand_site, cand_pos, nbr_pos, nbr_union, bands,
                             lo_c, hi_c):
    """Band-quota neighbour selection against a group's neighbour arrays,
    each candidate clamped to its member's window [lo_c, hi_c) of them:
    the torch form of the JAX package's _device_select_neighbors_clamped
    (snp_caller.py:417-461), equal to it exactly; K3's plain twin selects
    with it. Runs on the device of its inputs.

    cand_site, cand_pos, lo_c, hi_c: (B,) integer tensors; nbr_pos: (M,)
    sorted neighbour positions; nbr_union: (M,) their union-site indices;
    bands: a band_table (on any device; it is read on the host).
    Returns (B, 41) int32 union-site indices, −1 padding, the centre
    column = cand_site. Left neighbours are right-aligned to column
    CENTER − 1, right ones start at CENTER + 1."""
    table = torch.as_tensor(bands).tolist()
    dev = cand_pos.device
    B = cand_pos.shape[0]
    M = nbr_union.shape[0]
    pos = nbr_pos.long()
    cp = cand_pos.long()
    lo_c = lo_c.long()
    hi_c = hi_c.long()
    uni_of = nbr_union.long() if M else torch.zeros(1, dtype=torch.long,
                                                   device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    # one extra trash column absorbs the invalid slots
    soc = torch.full((B, WIDTH + 1), -1, dtype=torch.long, device=dev)
    for side, side_rows in zip(("left", "right"), table):
        sel_parts, val_parts = [], []
        for lo_off, hi_off, k, take in side_rows:
            if k == 0:
                continue
            i0 = torch.searchsorted(pos, cp + lo_off)
            i1 = torch.searchsorted(pos, cp + hi_off)
            i0 = torch.minimum(torch.maximum(i0, lo_c), hi_c)
            i1 = torch.minimum(torch.maximum(i1, lo_c), hi_c)
            cnt = torch.clamp(i1 - i0, max=k)
            start = i1 - cnt if take else i0
            ranks = torch.arange(k, device=dev)
            valid = ranks[None, :] < cnt[:, None]
            sel_parts.append(torch.where(valid, start[:, None] + ranks, 0))
            val_parts.append(valid)
        if not sel_parts:
            continue
        sel = torch.cat(sel_parts, dim=1)
        val = torch.cat(val_parts, dim=1)
        # the stable compaction of the valid slots to the front: a valid
        # slot's rank is the number of valid slots before it
        rank = torch.cumsum(val.long(), dim=1) - 1
        n = val.sum(dim=1)
        if side == "left":
            cols = CENTER - n[:, None] + rank
        else:
            cols = CENTER + 1 + rank
        uni = uni_of[sel.clamp(0, max(M - 1, 0))]
        soc[rows, torch.where(val, cols, WIDTH)] = torch.where(val, uni, -1)
    soc = soc[:, :WIDTH].clone()
    soc[:, CENTER] = cand_site.long()
    return soc.to(torch.int32)


def _csr_hit(indptr, rid, n_reads, s, q):
    """Whether (s, q) is an entry of the CSR (rows sorted by rid), and the
    entry's index: one search over the (site, rid) keys, which ascend
    because the entries are sorted by (site, rid)."""
    if rid.shape[0] == 0:
        return torch.zeros(s.shape, dtype=torch.bool, device=s.device), None
    S2 = indptr.shape[0] - 1
    site_of = torch.repeat_interleave(
        torch.arange(S2, device=s.device), indptr.diff().long())
    keys = site_of * n_reads + rid.long()
    want = s * n_reads + q
    pos = torch.searchsorted(keys, want).clamp_(max=keys.shape[0] - 1)
    return keys[pos] == want, pos


def cell_codes(wire, s, q):
    """Codes of reads q at union sites s (broadcast int64 tensors), as
    _group_cell_codes computes them; 4 where the read does not cover the
    site."""
    N = wire.n_reads
    lo = wire.read_lo.long()[q]
    covered = (lo <= s) & (s <= wire.read_hi.long()[q])
    hole, _ = _csr_hit(wire.hole_indptr, wire.hole_rid, N, s, q)
    covered &= ~hole
    T = wire.minor_bits.shape[0]
    if T:
        bit = (wire.span_start.long()[q] + s - lo).clamp(0, 8 * T - 1)
        minor = (wire.minor_bits.long()[bit >> 3] >> (bit & 7)) & 1
        code = torch.where(minor.bool(), wire.site_minor.long()[s],
                           wire.site_major.long()[s])
    else:
        code = wire.site_major.long()[s].expand(covered.shape)
    hit, pos = _csr_hit(wire.exc_indptr, wire.exc_rid, N, s, q)
    if pos is not None:
        code = torch.where(hit, wire.exc_code.long()[pos], code)
    return torch.where(covered, code, 4)


def snp_pileup_reference(wire, cand_site, cand_pos, lo_c, hi_c, norm,
                         deep_rids=None, n_valid=None):
    """Plain PyTorch twin of K3: the neighbour selection
    (select_neighbors_clamped), the (row, read) pairs each row counts
    (every read's interval and hole test at the centre site, or a deep
    row's ids), their cell codes at the row's 41 columns, a count per
    (row, centre base, column, code), then _snp_forward_dense's
    assembly. Same inputs and outputs as snp_pileup, on any device."""
    dev = cand_site.device
    B = cand_site.shape[0]
    N, S = wire.n_reads, wire.n_sites
    soc = select_neighbors_clamped(cand_site, cand_pos, wire.nbr_pos,
                                   wire.nbr_union, wire.bands.cpu(), lo_c,
                                   hi_c)
    if deep_rids is None:
        # the covering reads of the centre site, ascending
        s = cand_site.long().clamp(0, S)
        lo, hi = wire.read_lo.long(), wire.read_hi.long()
        iv = (lo[None, :] <= s[:, None]) & (s[:, None] <= hi[None, :])
        b_idx, q_idx = iv.nonzero(as_tuple=True)
        hole, _ = _csr_hit(wire.hole_indptr, wire.hole_rid, N, s[b_idx],
                           q_idx)
        b_idx, q_idx = b_idx[~hole], q_idx[~hole]
    else:
        D = deep_rids.shape[1]
        m = (torch.arange(D, device=dev)[None, :]
             < n_valid.long().clamp(max=D)[:, None])
        b_idx = m.nonzero(as_tuple=True)[0]
        q_idx = deep_rids.long()[m].clamp(0, max(N - 1, 0))
    sites = torch.where(soc >= 0, soc, S).long()
    code = cell_codes(wire, sites[b_idx], q_idx[:, None])  # (P, 41)
    g = code[:, CENTER]
    keep = (g < 4)[:, None] & (code < 4)
    w = torch.arange(WIDTH, device=dev)[None, :].expand_as(code)
    flat = (((b_idx[:, None] * 4 + g[:, None]) * WIDTH + w) * 5 + code)[keep]
    counts = torch.bincount(flat, minlength=B * 4 * WIDTH * 5)
    mat = counts.view(B, 4, WIDTH, 5)[..., :4].float()

    col_valid = soc >= 0
    site_ref = wire.site_ref.long()
    col_ref = torch.where(col_valid, site_ref[soc.long().clamp(0, S - 1)], 4)
    center_ref = site_ref[cand_site.long().clamp(0, S - 1)]
    ref = torch.nn.functional.one_hot(center_ref, 5)[:, :4].float()
    ch4 = ref[:, :, None] * col_valid[:, None, :].float()
    mat = torch.cat([mat, ch4[..., None]], dim=-1)  # (B, 4, 41, 5)
    total_ref = torch.nn.functional.one_hot(col_ref, 5).float()
    total_ref[..., 4] = 0.0
    flip = 1.0 - 2.0 * total_ref
    x = torch.cat([total_ref[:, None], mat * flip[:, None]], dim=1)
    x[:, 1:, :, :4] *= norm[:, None, None, None]
    return x, soc, ref
