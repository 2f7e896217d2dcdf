"""The traffic generators: a seed gives the same inputs, another seed other
contents at the same sizes, and a payload keeps the group wire's
invariants. Read lengths drawn from `read_len_dist` are the same for
every seed, and a mix without that key gives the groups it always did."""

import hashlib
import json
import os

import numpy as np
import pytest

from nbench import gen_snp

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**33 + 12345  # seeds may need more than 32 bits


def _traffic(name, **cut):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as fh:
        t = json.load(fh)
    t.update(cut)
    return t


SNP_CUT = dict(groups=2, members_per_group=3, member_bp=60000,
               halo_bp=20000)
# SHA-256 of every array of make_pool's groups at SNP_CUT (_digest),
# taken before read lengths could come from a distribution
DIGESTS = {
    SEED: "79f3c1c442077ad9c2cb1f1a95c0b7c44b69acd5f500d5916ee0b45cd96a898c",
    3: "9055cff24c0c96b788c71516a07f08b731ab5e7d64358b4305d3c5f04f24c13a"}


def _flat(group):
    out = {k: v for k, v in group.items()
           if isinstance(v, np.ndarray)}
    for i, m in enumerate(group["members"]):
        for k, v in m.items():
            out["m%d.%s" % (i, k)] = np.asarray(v)
    return out


def _digest(pool):
    h = hashlib.sha256()
    for g in pool:
        f = _flat(g)
        for k in sorted(f):
            a = np.ascontiguousarray(f[k])
            h.update(("%s %s %s;" % (k, a.dtype.str, a.shape)).encode())
            h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", [SEED, 3])
def test_snp_groups_repeat_for_a_seed(seed):
    _check_repeat(_traffic("ont_snp_stream", **SNP_CUT), seed)


@pytest.mark.parametrize("seed", [SEED, 3])
def test_ul_groups_repeat_for_a_seed(ul_reads, seed):
    _check_repeat(ul_reads(_traffic("ont_snp_stream", **SNP_CUT)), seed)


def _check_repeat(t, seed):
    a = gen_snp.make_pool(t, seed, 160, "ont")
    b = gen_snp.make_pool(t, seed, 160, "ont")
    c = gen_snp.make_pool(t, seed + 1, 160, "ont")
    for ga, gb, gc in zip(a, b, c):
        fa, fb, fc = _flat(ga), _flat(gb), _flat(gc)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        # another seed: other contents, the same sizes
        assert not np.array_equal(fa["read_lo"], fc["read_lo"])
        for k in ("read_lo", "site_ref", "nbr_pos", "m0.cand_site"):
            assert fa[k].shape == fc[k].shape, k
        assert gen_snp.rows_of(ga) == gen_snp.rows_of(gc)


@pytest.mark.parametrize("seed", sorted(DIGESTS))
def test_snp_groups_without_a_distribution_are_unchanged(seed):
    t = _traffic("ont_snp_stream", **SNP_CUT)
    assert "read_len_dist" not in t
    assert _digest(gen_snp.make_pool(t, seed, 160, "ont")) == DIGESTS[seed]


def test_snp_group_wire_invariants():
    _check_wire(_traffic("ont_snp_stream", **SNP_CUT))


def test_ul_group_wire_invariants(ul_reads):
    _check_wire(ul_reads(_traffic("ont_snp_stream", **SNP_CUT)))


def _check_wire(t):
    z = gen_snp.group_sizes(t)
    g = gen_snp.make_group(np.random.default_rng(SEED), t, 160, "ont")
    S, N = len(g["site_ref"]), len(g["read_lo"])
    assert (S, N) == (z["S"], z["N"])
    assert len(g["nbr_pos"]) == z["M"]
    assert (np.diff(g["nbr_pos"]) > 0).all()
    assert (np.diff(g["nbr_union"]) > 0).all()
    for site, rid in (("exc_site", "exc_rid"), ("hole_site", "hole_rid")):
        key = g[site].astype(np.int64) * N + g[rid]
        assert (np.diff(key) > 0).all()
        lo, hi = g["read_lo"][g[rid]], g["read_hi"][g[rid]]
        assert ((lo <= g[site]) & (g[site] <= hi)).all()
    both = np.intersect1d(g["exc_site"].astype(np.int64) * N + g["exc_rid"],
                          g["hole_site"].astype(np.int64) * N + g["hole_rid"])
    assert len(both) == 0
    cells = int(np.maximum(g["read_hi"].astype(np.int64) - g["read_lo"] + 1,
                           0).sum())
    assert len(g["minor_bits"]) == (cells + 7) // 8
    assert abs(len(g["exc_rid"]) - t["exception_share"] * cells) <= 1
    for m in g["members"]:
        assert len(m["cand_site"]) == z["rows_member"]
        assert 0 <= m["nbr_lo"] <= m["nbr_hi"] <= z["M"]
        np.testing.assert_array_equal(m["cand_pos32"],
                                      m["pos"].astype(np.int32))
        assert (m["sampled_depth"] <= 160).all()


def _n50(lengths):
    desc = np.sort(lengths)[::-1]
    acc = np.cumsum(desc)
    return int(desc[np.searchsorted(acc, acc[-1] / 2)])


def test_ul_read_lengths_are_the_same_for_every_seed(ul_reads):
    """At the full mix: the seed deals out one multiset of lengths, whose
    N50 and longest read are the distribution's."""
    t = ul_reads(_traffic("ont_snp_stream"))
    z = gen_snp.group_sizes(t)
    got = []
    for seed in (SEED, 3):
        starts, ends = gen_snp.read_intervals(np.random.default_rng(seed), t,
                                              z["region_bp"], z["N"])
        got.append((starts, np.sort(ends - starts)))
    assert not np.array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])
    lengths = got[0][1]
    np.testing.assert_array_equal(lengths,
                                  gen_snp.read_lengths(t, z["N"]))
    dist = t["read_len_dist"]
    assert abs(_n50(lengths) / dist["n50_bp"] - 1) < 0.01
    assert lengths[-1] == dist["max_bp"]
    assert abs(lengths.mean() / gen_snp.mean_read_len(t) - 1) < 0.01


def test_ul_reads_overlap_the_region(ul_reads):
    t = ul_reads(_traffic("ont_snp_stream"))
    z = gen_snp.group_sizes(t)
    starts, ends = gen_snp.read_intervals(np.random.default_rng(SEED), t,
                                          z["region_bp"], z["N"])
    assert len(starts) == z["N"]
    assert (np.diff(starts) >= 0).all()
    assert (starts < z["region_bp"]).all() and (ends > 0).all()
    cut = ul_reads(_traffic("ont_snp_stream", **SNP_CUT))
    zc = gen_snp.group_sizes(cut)
    g = gen_snp.make_group(np.random.default_rng(SEED), cut, 160, "ont")
    assert (len(g["site_ref"]), len(g["read_lo"])) == (zc["S"], zc["N"])


def test_ul_windows_outgrow_k3s_read_list(ul_reads):
    """K3 scans a site's read window (read_windows: from the first read in
    start order whose running end reaches the site) in rounds of 256
    reads. At a 500 kb cut, seed 3 draws a read that spans the region, so
    every window after its start holds every read started since."""
    from nanocaller_tpu_torch.pileup.snp_pileup import read_windows

    t = ul_reads(_traffic("ont_snp_stream", groups=1, members_per_group=2,
                          member_bp=200000, halo_bp=50000))
    g = gen_snp.make_group(np.random.default_rng(3), t, 160, "ul_ont")
    S = len(g["site_ref"])
    assert ((g["read_lo"] == 0) & (g["read_hi"] == S - 1)).any()
    _order, k0, k1 = read_windows(g["read_lo"], g["read_hi"], S)
    assert ((k1 - k0)[:S] > 256).any()
