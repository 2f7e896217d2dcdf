"""The plain references: the SNP pileup and the SNP CNN in plain PyTorch,
from the benchmark's own inputs and the weight packs read by path.
Nothing here imports the port.

- `snp_pileup`: the (B, 5, 41, 5) float32 NHWC pileup of candidate rows
  against a group payload (benchmark/nbench/gen_snp.py's dicts), by the
  semantics of nanocaller_tpu_torch's SnpGroupFeatures: a read covers
  union site s where read_lo <= s <= read_hi and (s, read) is no hole; a
  covered cell's code is its exception's code, else the site's minor code
  where the read's minor bit is set, else its major code; each row
  selects up to 20 neighbour sites a side by its band schedule within its
  member's window of the neighbour list, counts the codes of the reads
  that cover its centre (or, for a deep row, its sampled reads) at its 41
  columns by the read's centre base, flips the counts at each column's
  reference base, scales them by the member's coverage factor and puts
  the columns' reference one-hot in row 0 and the centre's in channel 4.
  A frozen copy of the port's plain twin of kernel K3
  (pileup/snp_pileup.snp_pileup_reference), rewritten over these dicts.
- `snp_cnn`: the published NanoCaller SNP network (the widths in the
  configuration file's `snp_cnn`), from the flat
  "layer/kernel" npz packs, in float32. `precision(tf32)` sets whether
  cuDNN and cuBLAS may use TF32 (the control) or not (the reference).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F

WIDTH, CENTER = 41, 20


def load_pack(path):
    """A flat npz pack → {layer: {"kernel": ..., "bias": ...}} float32,
    and the `.coverage` sidecar's training depth (0.0 without one)."""
    flat = np.load(path)
    tree = {}
    for key in flat.files:
        layer, var = key.rsplit("/", 1)
        tree.setdefault(layer, {})[var] = np.asarray(flat[key], np.float32)
    cov_path = path[:-len(".npz")] + ".coverage"
    cov = 0.0
    if os.path.exists(cov_path):
        with open(cov_path) as fh:
            cov = float(fh.readline().strip())
    return tree, cov


def to_device(tree, device):
    """Conv kernels HWIO → OIHW, dense kernels (in, out) → (out, in)."""
    out = {}
    for layer, v in tree.items():
        k = v["kernel"]
        k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        out[layer] = (torch.from_numpy(np.ascontiguousarray(k)).to(device),
                      torch.from_numpy(v["bias"]).to(device))
    return out


@contextlib.contextmanager
def precision(tf32):
    """cuDNN convolutions and matmuls in TF32 (tf32=True, the control) or
    in full float32, deterministic algorithms either way; restored on
    exit."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = bool(tf32)
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic, b.cudnn.benchmark) = saved


def _conv(p, name, x, stride=1, padding=0):
    w, b = p[name]
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def _dense(p, name, x):
    w, b = p[name]
    return x @ w.T + b


def _trunk(p, x):
    """NHWC input → the three parallel first convolutions (flax SAME
    padding, symmetric for odd kernels), two strided convolutions, all
    with SELU, flattened in NHWC order."""
    x = x.permute(0, 3, 1, 2)
    m = torch.cat([F.selu(_conv(p, "conv1_1", x, padding=(0, 2))),
                   F.selu(_conv(p, "conv1_2", x, padding=(2, 0))),
                   F.selu(_conv(p, "conv1_3", x, padding=(2, 2)))], dim=1)
    m = F.selu(_conv(p, "conv2", m, stride=(1, 2)))
    m = F.selu(_conv(p, "conv3", m, stride=(1, 2)))
    return m.permute(0, 2, 3, 1).reshape(m.shape[0], -1)


def snp_cnn(p, x, ref):
    """Diploid SNP model: x (B, 5, 41, 5), ref (B, 4) → (B, 4) the A, G,
    T, C heads' probability that the base is present."""
    fc1 = F.selu(_dense(p, "fc1", _trunk(p, x)))
    fa = F.selu(_dense(p, "fa", fc1))
    return torch.stack([
        torch.softmax(_dense(p, h, torch.cat([fa, ref[:, i:i + 1]], 1)),
                      -1)[:, 1] for i, h in enumerate("AGTC")], dim=1)


def band_rows(bands):
    """A configuration's `neighbour_bands` ({"left", "right": [[lo_off,
    hi_off, k, "first" | "last"]]}) → per side [(lo, hi, k, take_last)]."""
    return [[(lo, hi, k, take == "last") for lo, hi, k, take in bands[side]]
            for side in ("left", "right")]


def select_neighbors(cand_site, cand_pos, nbr_pos, nbr_union, bands,
                     lo_c, hi_c):
    """(B, 41) int64 union sites of each row's columns, -1 where empty,
    the centre the candidate's own site: per band the last or first k
    neighbours in [cand_pos + lo_off, cand_pos + hi_off), clamped to the
    row's window [lo_c, hi_c) of the neighbour list; the left bands'
    picks right-aligned before the centre, the right ones after it."""
    dev = cand_pos.device
    B, M = cand_pos.shape[0], nbr_pos.shape[0]
    pos = nbr_pos.long()
    cp, lo_c, hi_c = cand_pos.long(), lo_c.long(), hi_c.long()
    uni_of = nbr_union.long() if M else torch.zeros(1, dtype=torch.long,
                                                   device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    soc = torch.full((B, WIDTH + 1), -1, dtype=torch.long, device=dev)
    for side, rows_ in zip(("left", "right"), band_rows(bands)):
        sel_parts, val_parts = [], []
        for lo_off, hi_off, k, take_last in rows_:
            i0 = torch.searchsorted(pos, cp + lo_off)
            i1 = torch.searchsorted(pos, cp + hi_off)
            i0 = torch.minimum(torch.maximum(i0, lo_c), hi_c)
            i1 = torch.minimum(torch.maximum(i1, lo_c), hi_c)
            cnt = torch.clamp(i1 - i0, max=k)
            start = i1 - cnt if take_last else i0
            ranks = torch.arange(k, device=dev)
            valid = ranks[None, :] < cnt[:, None]
            sel_parts.append(torch.where(valid, start[:, None] + ranks, 0))
            val_parts.append(valid)
        sel, val = torch.cat(sel_parts, 1), torch.cat(val_parts, 1)
        rank = torch.cumsum(val.long(), dim=1) - 1
        n = val.sum(dim=1)
        cols = CENTER - n[:, None] + rank if side == "left" \
            else CENTER + 1 + rank
        uni = uni_of[sel.clamp(0, max(M - 1, 0))]
        soc[rows, torch.where(val, cols, WIDTH)] = torch.where(val, uni, -1)
    soc = soc[:, :WIDTH].clone()
    soc[:, CENTER] = cand_site.long()
    return soc


class GroupTables:
    """A group payload's arrays on a device, with the (site, read) keys of
    its exception and hole lists (both sorted by (site, read))."""

    def __init__(self, g, device):
        t = lambda a, dt=torch.long: torch.as_tensor(np.asarray(a)).to(
            device=device, dtype=dt)
        self.N = len(g["read_lo"])
        self.S = len(g["site_ref"])
        self.read_lo, self.read_hi = t(g["read_lo"]), t(g["read_hi"])
        span = (self.read_hi - self.read_lo + 1).clamp(min=0)
        self.span_start = torch.cumsum(span, 0) - span
        self.site_ref, self.site_major = t(g["site_ref"]), t(g["site_major"])
        self.site_minor = t(g["site_minor"])
        self.bits = t(np.unpackbits(g["minor_bits"], bitorder="little"),
                      torch.uint8)
        self.exc_keys = t(g["exc_site"]) * self.N + t(g["exc_rid"])
        self.exc_code = t(g["exc_code"])
        self.hole_keys = t(g["hole_site"]) * self.N + t(g["hole_rid"])
        self.nbr_pos, self.nbr_union = t(g["nbr_pos"]), t(g["nbr_union"])

    @staticmethod
    def _hit(keys, want):
        if keys.shape[0] == 0:
            return torch.zeros(want.shape, dtype=torch.bool,
                               device=want.device), None
        i = torch.searchsorted(keys, want).clamp_(max=keys.shape[0] - 1)
        return keys[i] == want, i

    def codes(self, s, q):
        """Codes of reads q at sites s (broadcast int64), 4 where the read
        does not cover the site (s == S: the empty column)."""
        lo = self.read_lo[q]
        sc = s.clamp(max=self.S - 1)
        covered = (lo <= s) & (s <= self.read_hi[q]) & (s < self.S)
        hole, _ = self._hit(self.hole_keys, s * self.N + q)
        covered &= ~hole
        bit = (self.span_start[q] + s - lo).clamp(0, max(
            self.bits.shape[0] - 1, 0))
        minor = self.bits[bit].bool() if self.bits.shape[0] else \
            torch.zeros_like(covered)
        code = torch.where(minor, self.site_minor[sc], self.site_major[sc])
        hit, i = self._hit(self.exc_keys, s * self.N + q)
        if i is not None:
            code = torch.where(hit, self.exc_code[i], code)
        return torch.where(covered, code, 4)


def snp_pileup(tab, bands, cand_site, cand_pos, lo_c, hi_c, norm,
               deep_rids=None):
    """The pileups of B rows of one group (GroupTables) → (x (B, 5, 41, 5)
    float32, ref (B, 4) the centre's reference one-hot, zero for N, and
    the counts of what the rows needed: covering (row, read) pairs,
    counted cells, selected columns)."""
    dev = cand_site.device
    B, N, S = cand_site.shape[0], tab.N, tab.S
    soc = select_neighbors(cand_site, cand_pos, tab.nbr_pos, tab.nbr_union,
                           bands, lo_c, hi_c)
    if deep_rids is None:
        s = cand_site.long()
        iv = (tab.read_lo[None, :] <= s[:, None]) & \
            (s[:, None] <= tab.read_hi[None, :])
        b_idx, q_idx = iv.nonzero(as_tuple=True)
        hole, _ = tab._hit(tab.hole_keys, s[b_idx] * N + q_idx)
        b_idx, q_idx = b_idx[~hole], q_idx[~hole]
    else:
        D = deep_rids.shape[1]
        b_idx = torch.arange(B, device=dev).repeat_interleave(D)
        q_idx = deep_rids.long().reshape(-1)
    sites = torch.where(soc >= 0, soc, S)
    code = tab.codes(sites[b_idx], q_idx[:, None])  # (P, 41)
    g = code[:, CENTER]
    keep = (g < 4)[:, None] & (code < 4)
    w = torch.arange(WIDTH, device=dev)[None, :].expand_as(code)
    flat = (((b_idx[:, None] * 4 + g[:, None]) * WIDTH + w) * 5 + code)[keep]
    counts = torch.bincount(flat, minlength=B * 4 * WIDTH * 5)
    mat = counts.view(B, 4, WIDTH, 5)[..., :4].float()
    col_valid = soc >= 0
    col_ref = torch.where(col_valid, tab.site_ref[soc.clamp(0, S - 1)], 4)
    center_ref = tab.site_ref[cand_site.long().clamp(0, S - 1)]
    ref = F.one_hot(center_ref, 5)[:, :4].float()
    ch4 = ref[:, :, None] * col_valid[:, None, :].float()
    mat = torch.cat([mat, ch4[..., None]], dim=-1)
    total_ref = F.one_hot(col_ref, 5).float()
    total_ref[..., 4] = 0.0
    flip = 1.0 - 2.0 * total_ref
    x = torch.cat([total_ref[:, None], mat * flip[:, None]], dim=1)
    x[:, 1:, :, :4] *= norm[:, None, None, None]
    need = {"covering_reads": int(b_idx.shape[0]),
            "counted_cells": int(keep.sum()),
            "counted_reads": int((g < 4).sum()),
            "cell_codes": int(b_idx.shape[0])
            + int(((g < 4)[:, None] & col_valid[b_idx]).sum())
            - int((g < 4).sum()),
            "selected_columns": int(col_valid.sum()) - B}
    return x, ref, need
