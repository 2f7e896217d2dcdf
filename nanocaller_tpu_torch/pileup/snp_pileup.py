"""K3 `snp_pileup`: the SNP group pileup from the group payload, its plain
PyTorch twin, and its launch counter.

The hand-written CUDA kernel (csrc/snp_pileup.cu, built with K1 and K2
into the library of align/nw_kernels.py) replaces the XLA-jitted body of
nanocaller_tpu/snp_caller.py's group kernel between neighbour selection
and the CNN: the covering-read list (`_rid_matrix` over the interval and
hole test), the table-free cell codes (`_group_cell_codes`) and the
pileup assembly of `_snp_forward_dense` (one-hot einsum, ref channel,
flip, coverage scale). One launch takes a cohort of candidate rows
against one group payload and writes the (B, 5, 41, 5) float32 NHWC
tensor the SNP CNN takes.

`snp_pileup` takes its twin `snp_pileup_reference` only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..align import nw_kernels
from .snp_features import CENTER, WIDTH

# launches of K3 (the wrapper adds one where it launches the kernel)
SNP_PILEUP_LAUNCHES = 0


def reset_counters():
    global SNP_PILEUP_LAUNCHES
    SNP_PILEUP_LAUNCHES = 0


@dataclass
class PileupWire:
    """One group's observation payload on a device (SnpGroupFeatures'
    arrays, int32 indices and int8/uint8 codes):

    read_lo, read_hi, span_start  int32 (N); span_start is the exclusive
                                  cumsum of max(hi - lo + 1, 0)
    site_ref, site_major, site_minor  int8 (S + 1); trash row S holds 4
    minor_bits                    uint8 (T)
    exc_indptr, hole_indptr       int32 (S + 2), CSR rows over the sites
    exc_rid, exc_code             int32 / int8 (E)
    hole_rid                      int32 (H)
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

    @property
    def n_reads(self):
        return self.read_lo.shape[0]

    @property
    def n_sites(self):
        return self.site_ref.shape[0] - 1

    def tensors(self):
        """The fields in declaration order, the kernel's argument order."""
        return tuple(getattr(self, f.name) for f in fields(self))


def group_wire(gf, device):
    """A group payload's host arrays (SnpGroupFeatures, or any object with
    its read_lo, read_hi, site_*, minor_bits, exc_* and hole_* fields) →
    a PileupWire on `device`: the trash site row, the CSR row pointers
    over S + 2 rows and the span offsets, as the JAX package's
    infer_snp_group and _group_cell_codes derive them."""
    S = len(gf.site_ref)
    i32 = np.int32
    trash = np.full(1, 4, np.int8)
    read_lo = np.asarray(gf.read_lo, i32)
    read_hi = np.asarray(gf.read_hi, i32)
    spans = np.maximum(read_hi.astype(np.int64) - read_lo + 1, 0)
    span_start = np.zeros(len(spans), i32)
    if len(spans) > 1:
        span_start[1:] = np.cumsum(spans[:-1])
    rows = np.arange(S + 2, dtype=i32)
    site = lambda a: np.concatenate([np.asarray(a, np.int8), trash])
    host = dict(
        read_lo=read_lo, read_hi=read_hi, span_start=span_start,
        site_ref=site(gf.site_ref), site_major=site(gf.site_major),
        site_minor=site(gf.site_minor),
        minor_bits=np.asarray(gf.minor_bits, np.uint8),
        exc_indptr=np.searchsorted(gf.exc_site, rows).astype(i32),
        exc_rid=np.asarray(gf.exc_rid, i32),
        exc_code=np.asarray(gf.exc_code, np.int8),
        hole_indptr=np.searchsorted(gf.hole_site, rows).astype(i32),
        hole_rid=np.asarray(gf.hole_rid, i32))
    return PileupWire(**{k: torch.from_numpy(np.ascontiguousarray(v))
                         .to(device) for k, v in host.items()})


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


_WIRE_DTYPES = {
    "read_lo": torch.int32, "read_hi": torch.int32, "span_start": torch.int32,
    "site_ref": torch.int8, "site_major": torch.int8, "site_minor": torch.int8,
    "minor_bits": torch.uint8, "exc_indptr": torch.int32,
    "exc_rid": torch.int32, "exc_code": torch.int8,
    "hole_indptr": torch.int32, "hole_rid": torch.int32}


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


def _check_inputs(wire, cand_site, soc, norm, deep_rids, n_valid):
    dev = soc.device if isinstance(soc, torch.Tensor) else None
    if dev is None or dev.type not in ("cpu", "cuda"):
        raise ValueError("soc must be a CPU or CUDA tensor")
    N, S, E = wire.n_reads, wire.n_sites, wire.exc_rid.shape[0]
    shapes = dict(
        read_lo=(N,), read_hi=(N,), span_start=(N,), site_ref=(S + 1,),
        site_major=(S + 1,), site_minor=(S + 1,),
        minor_bits=(wire.minor_bits.shape[0],), exc_indptr=(S + 2,),
        exc_rid=(E,), exc_code=(E,), hole_indptr=(S + 2,),
        hole_rid=(wire.hole_rid.shape[0],))
    for f in fields(wire):
        _check(getattr(wire, f.name), f.name, _WIRE_DTYPES[f.name],
               shapes[f.name], dev)
    B = soc.shape[0] if soc.dim() == 2 else -1
    _check(soc, "soc", torch.int32, (B, WIDTH), dev)
    _check(cand_site, "cand_site", torch.int32, (B,), dev)
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


def snp_pileup(wire, cand_site, soc, norm, deep_rids=None, n_valid=None):
    """Pileups of B candidate rows against one group payload.

    wire: PileupWire; cand_site (B,) int32 union-site index; soc (B, 41)
    int32 site of each column (−1 padding, soc[:, 20] = cand_site); norm
    (B,) float32 coverage scale; for deep rows deep_rids (B, D) int32
    explicit read ids and n_valid (B,) int32 (the first n_valid count).
    → x (B, 5, 41, 5) float32, NHWC: row 0 the columns' ref one-hot,
    rows 1-4 the signed, scaled counts of the reads with centre base
    A/G/T/C and the ref channel. Normal rows count every covering read of
    the centre site (the caller keeps them within maxcov: see
    snp_caller.pileup_cohorts)."""
    global SNP_PILEUP_LAUNCHES
    B = _check_inputs(wire, cand_site, soc, norm, deep_rids, n_valid)
    if soc.device.type == "cpu":
        return snp_pileup_reference(wire, cand_site, soc, norm, deep_rids,
                                    n_valid)
    out = torch.empty((B, 5, WIDTH, 5), dtype=torch.float32,
                      device=soc.device)
    if B == 0:
        return out
    lib = nw_kernels._lib()
    ptr = lambda t: t.data_ptr() if t is not None and t.numel() else None
    with torch.cuda.device(soc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.snp_pileup_launch(
            *[ptr(t) for t in wire.tensors()], wire.n_reads, wire.n_sites,
            wire.minor_bits.shape[0], ptr(cand_site), ptr(soc), ptr(norm),
            ptr(deep_rids), ptr(n_valid),
            0 if deep_rids is None else deep_rids.shape[1], B,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("snp_pileup launch failed: cudaError %d" % rc)
    SNP_PILEUP_LAUNCHES += 1
    return out


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


def snp_pileup_reference(wire, cand_site, soc, norm, deep_rids=None,
                         n_valid=None):
    """Plain PyTorch twin of K3: the (row, read) pairs each row counts,
    their cell codes at the row's 41 columns, a count per (row, centre
    base, column, code), then _snp_forward_dense's assembly. Same inputs
    and output as snp_pileup, on any device."""
    dev = soc.device
    B = soc.shape[0]
    N, S = wire.n_reads, wire.n_sites
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
    ref_eq = torch.nn.functional.one_hot(center_ref, 5)[:, :4].float()
    ch4 = ref_eq[:, :, None] * col_valid[:, None, :].float()
    mat = torch.cat([mat, ch4[..., None]], dim=-1)  # (B, 4, 41, 5)
    total_ref = torch.nn.functional.one_hot(col_ref, 5).float()
    total_ref[..., 4] = 0.0
    flip = 1.0 - 2.0 * total_ref
    x = torch.cat([total_ref[:, None], mat * flip[:, None]], dim=1)
    x[:, 1:, :, :4] *= norm[:, None, None, None]
    return x
