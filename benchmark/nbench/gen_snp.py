"""SNP decode-group payloads drawn from a seed, at the statistics of a
traffic file.

A group is what the port's feature workers send the device owner at
genome scale: `members_per_group` coordinate-adjacent 500 kb SNP chunks
decoded once with a halo on each side (the CLI groups 8 Mb of chunks
while the group stays under its read and site caps). Its payload is the
group-level observation wire of nanocaller_tpu_torch's SnpGroupFeatures:
union sites, reads as intervals over them, a minor-bit per covered cell,
exception and hole CSRs, the sorted neighbour sites, and per member its
candidate rows and neighbour window.

Every size is fixed by the traffic file (sites a member and a halo,
reads, candidates, neighbours, exceptions and holes as shares of the
cells), so every seed gives the same shapes; the seed draws positions,
codes and which cells are exceptions or holes. Reads are all
`read_len_bp` long, or, where the file gives `read_len_dist`, of lengths
drawn from that distribution at fixed quantiles (`read_lengths`): the
same lengths for every seed, which only deals them out to starts, since
the tail of the lengths sets how many reads K3 scans a row. Groups are
plain dicts of numpy arrays, so that the port's payload and the
reference are built from the same arrays.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def _weights(w):
    w = np.asarray(w, np.float64)
    return w / w.sum()


def _choose(rng, n, k):
    """k distinct sorted indices of range(n)."""
    k = min(int(k), n)
    return np.sort(rng.choice(n, size=k, replace=False)) if k else \
        np.zeros(0, np.int64)


def _lognormal(dist):
    """(mu, sigma, cap) of a `read_len_dist`: a log-normal whose N50 (the
    median of the length-weighted lengths, exp(mu + sigma^2)) is
    `n50_bp`, capped at `max_bp`."""
    if dist.get("kind") != "lognormal":
        raise ValueError("read_len_dist: unknown kind %r" % dist.get("kind"))
    sigma = float(dist["sigma"])
    if not (sigma > 0 and 0 < dist["n50_bp"] <= dist["max_bp"]):
        raise ValueError("read_len_dist: needs sigma > 0 and "
                         "0 < n50_bp <= max_bp, got %r" % (dist,))
    return math.log(dist["n50_bp"]) - sigma * sigma, sigma, dist["max_bp"]


def mean_read_len(traffic):
    """The mean read length in bp: `read_len_bp`, or the mean of the
    capped `read_len_dist`, E[min(L, cap)] for L log-normal."""
    dist = traffic.get("read_len_dist")
    if dist is None:
        return traffic["read_len_bp"]
    mu, sigma, cap = _lognormal(dist)
    nd, c = NormalDist(), math.log(cap)
    return (math.exp(mu + sigma * sigma / 2)
            * nd.cdf((c - mu - sigma * sigma) / sigma)
            + cap * (1.0 - nd.cdf((c - mu) / sigma)))


def read_lengths(traffic, n):
    """The n read lengths of a group with `read_len_dist`, ascending
    int64: the distribution's quantiles at (i + 0.5) / n, capped at
    `max_bp`, the longest at `max_bp` itself. The same for every seed."""
    mu, sigma, cap = _lognormal(traffic["read_len_dist"])
    inv = NormalDist().inv_cdf
    z = np.array([inv((i + 0.5) / n) for i in range(n)])
    out = np.minimum(np.rint(np.exp(mu + sigma * z)), cap).astype(np.int64)
    if n:
        out[-1] = cap
    return out


def group_sizes(traffic):
    """The fixed sizes of every group of a traffic mix: sites a member and
    a halo side, members, reads, candidate rows a member, neighbours."""
    mb = 1e-6
    member_bp, halo_bp = traffic["member_bp"], traffic["halo_bp"]
    members = traffic["members_per_group"]
    s_member = int(round(traffic["union_sites_per_mb"] * member_bp * mb))
    s_halo = int(round(traffic["union_sites_per_mb"] * halo_bp * mb))
    S = members * s_member + 2 * s_halo
    region_bp = members * member_bp + 2 * halo_bp
    N = int(round(traffic["reads_per_mb"]
                  * (region_bp + mean_read_len(traffic)) * mb))
    return {"members": members, "s_member": s_member, "s_halo": s_halo,
            "S": S, "N": N, "region_bp": region_bp,
            "rows_member": int(round(traffic["cand_share_of_sites"]
                                     * s_member)),
            "M": int(round(traffic["nbr_share_of_sites"] * S))}


def read_intervals(rng, traffic, region_bp, N):
    """The reads' [start, end) in bp, in start order. Fixed lengths start
    uniformly in [-read_len_bp, region_bp). With `read_len_dist` the seed
    deals the fixed lengths out to the reads, and a read of length L
    starts uniformly in [1 - L, region_bp), so that each overlaps the
    region and the depth is the same all over it."""
    if "read_len_dist" not in traffic:
        read_len = traffic["read_len_bp"]
        starts = np.sort(rng.integers(-read_len, region_bp, N))
        return starts, starts + read_len
    length = read_lengths(traffic, N)[rng.permutation(N)]
    starts = rng.integers(1 - length, region_bp)
    order = np.argsort(starts, kind="stable")
    return starts[order], starts[order] + length[order]


def make_group(rng, traffic, maxcov, seq_type):
    """One group payload: a dict of the wire arrays (SnpGroupFeatures'
    field names) and `members`, a list of dicts of each member's rows
    (SnpGroupMember's field names)."""
    z = group_sizes(traffic)
    member_bp, halo_bp = traffic["member_bp"], traffic["halo_bp"]
    S, N, M = z["S"], z["N"], z["M"]
    # union sites: a fixed count in each member's chunk and each halo
    spans = [(0, halo_bp, z["s_halo"])]
    for m in range(z["members"]):
        lo = halo_bp + m * member_bp
        spans.append((lo, lo + member_bp, z["s_member"]))
    spans.append((z["region_bp"] - halo_bp, z["region_bp"], z["s_halo"]))
    site_pos = np.concatenate([
        np.sort(rng.choice(hi - lo, size=k, replace=False)) + lo
        for lo, hi, k in spans]).astype(np.int64)
    # reads: uniform starts (so uniform depth over the region), in start
    # order, as intervals over the union sites
    starts, ends = read_intervals(rng, traffic, z["region_bp"], N)
    lo = np.searchsorted(site_pos, starts, side="left")
    hi = np.searchsorted(site_pos, ends, side="left") - 1
    empty = lo > hi
    read_lo = np.where(empty, 1, lo).astype(np.int32)
    read_hi = np.where(empty, 0, hi).astype(np.int32)
    span = np.maximum(read_hi.astype(np.int64) - read_lo + 1, 0)
    total = int(span.sum())
    # every covered cell as a (site, rid) key; exceptions and holes are
    # disjoint random subsets of fixed shares
    rid = np.repeat(np.arange(N, dtype=np.int64), span)
    site = (np.repeat(read_lo.astype(np.int64), span) + np.arange(total)
            - np.repeat(np.cumsum(span) - span, span))
    keys = np.sort(site * N + rid)
    n_exc = int(round(traffic["exception_share"] * total))
    n_hole = int(round(traffic["hole_share"] * total))
    pick = rng.permutation(total)[:n_exc + n_hole]
    exc = np.sort(keys[pick[:n_exc]])
    hole = np.sort(keys[pick[n_exc:]])
    minor_bits = np.packbits(rng.random(total) < traffic["minor_bit_share"],
                             bitorder="little")
    site_ref = rng.choice(5, S, p=_weights(traffic["site_ref_weights"]))
    other = (site_ref % 4 + rng.integers(1, 4, S)) % 4
    site_major = np.where(rng.random(S) < traffic["major_is_ref_share"],
                          site_ref % 4, other)
    site_minor = (site_major + rng.integers(1, 4, S)) % 4
    exc_code = rng.choice(5, n_exc, p=_weights(traffic["exc_code_weights"]))
    nbr_union = _choose(rng, S, M)
    nbr_pos = site_pos[nbr_union]
    i32, i8 = np.int32, np.int8
    wire = dict(
        read_lo=read_lo, read_hi=read_hi, site_ref=site_ref.astype(i8),
        site_major=site_major.astype(i8), site_minor=site_minor.astype(i8),
        minor_bits=minor_bits, exc_site=(exc // N).astype(i32),
        exc_rid=(exc % N).astype(i32), exc_code=exc_code.astype(i8),
        hole_site=(hole // N).astype(i32), hole_rid=(hole % N).astype(i32),
        nbr_pos=nbr_pos.astype(i32), nbr_union=nbr_union.astype(i32))
    # covering reads of each site, less its holes
    live = ~empty
    cover = np.cumsum(np.bincount(read_lo[live], minlength=S + 1)
                      - np.bincount(read_hi[live] + 1, minlength=S + 1))[:S]
    depth = cover - np.bincount(wire["hole_site"], minlength=S)[:S]
    hole_keys = set(hole.tolist()) if n_hole else set()
    members = []
    for m in range(z["members"]):
        first = z["s_halo"] + m * z["s_member"]
        rows = first + _choose(rng, z["s_member"], z["rows_member"])
        c_lo = halo_bp + m * member_bp
        d = depth[rows]
        deep_idx = np.flatnonzero(d > maxcov)
        deep_rids = np.zeros((len(deep_idx), maxcov), np.int32)
        for k, j in enumerate(deep_idx):
            s = int(rows[j])
            cov = np.flatnonzero((read_lo <= s) & (s <= read_hi) & live)
            cov = np.array([q for q in cov if s * N + q not in hole_keys],
                           np.int64)
            deep_rids[k] = np.sort(rng.choice(cov, maxcov, replace=False))
        sampled = np.minimum(d, maxcov)
        members.append(dict(
            cand_site=rows.astype(i32), cand_pos32=site_pos[rows].astype(i32),
            nbr_lo=int(np.searchsorted(nbr_pos, c_lo - halo_bp)),
            nbr_hi=int(np.searchsorted(nbr_pos, c_lo + member_bp + halo_bp)),
            deep_idx=deep_idx.astype(np.int64), deep_rids=deep_rids,
            pos=site_pos[rows].astype(np.int64),
            center_ref=site_ref[rows].astype(i8), dp=d.astype(np.int64),
            sampled_depth=sampled.astype(np.int64)))
    wire["members"] = members
    wire["seq_type"] = seq_type
    wire["maxcov"] = maxcov
    return wire


def make_pool(traffic, seed, maxcov, seq_type):
    """The `groups` payloads of a run, from one seed; seq_type names the
    neighbour band schedule (the configuration's `sequencing`)."""
    rng = np.random.default_rng(seed)
    return [make_group(rng, traffic, maxcov, seq_type)
            for _ in range(traffic["groups"])]


def rows_of(group):
    return sum(len(m["cand_site"]) for m in group["members"])
