"""The traffic generators: a seed gives the same inputs, another seed other
contents at the same sizes, and a payload keeps the group wire's
invariants."""

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


def _flat(group):
    out = {k: v for k, v in group.items()
           if isinstance(v, np.ndarray)}
    for i, m in enumerate(group["members"]):
        for k, v in m.items():
            out["m%d.%s" % (i, k)] = np.asarray(v)
    return out


@pytest.mark.parametrize("seed", [SEED, 3])
def test_snp_groups_repeat_for_a_seed(seed):
    t = _traffic("ont_snp_stream", **SNP_CUT)
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


def test_snp_group_wire_invariants():
    t = _traffic("ont_snp_stream", **SNP_CUT)
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
