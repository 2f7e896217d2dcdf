"""The port's per-chunk and dense SNP paths against the JAX package on a
small fixture: the chunk payloads (get_snp_chunk_features,
get_snp_candidates, get_snp_group_features; diploid, haploid, deep rows,
an empty chunk, a chunk over _TABLE_CELL_CAP) field for field; K3 on a
chunk wire (its twin) against JAX infer_snp_chunk on its fused and its
split+deep routes, and its column sites against
_device_select_neighbors (exact); K5's twin against assemble_matrices_np
(exact) and JAX infer_snp_batch (atol 2e-5); and the CNN input x of one
member's candidates equal, bit for bit, across the port's three routes
(a group of one on K3, the chunk wire on K3, the dense batch on K5); and
SiteCodes.indexed_keys against the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nanocaller_tpu import snp_caller as J
from nanocaller_tpu.io.bam import BamReader as JBamReader
from nanocaller_tpu.io.fasta import FastaFile as JFastaFile
from nanocaller_tpu.pileup import snp_features as j_sf
from nanocaller_tpu_torch import snp_caller as P
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile
from nanocaller_tpu_torch.pileup import snp_dense as K5
from nanocaller_tpu_torch.pileup import snp_features as p_sf
from nanocaller_tpu_torch.pileup import snp_pileup as K3
from nanocaller_tpu_torch.runtime.metrics import total

from fixtures import BASES, make_fixture, random_seq
from torch_threads import _torch_threads  # noqa: F401 (autouse)

L = 100_000
# a 50 kb chunk (its scan window is the whole contig), and the group of
# test_torch_snp.py: four 25 kb members, the second without a candidate
CHUNK = {"chrom": "chr_t", "start": 1, "end": 50_000}
MEMBERS = [{"chrom": "chr_t", "start": 1 + i * 25000,
            "end": (i + 1) * 25000, "ploidy": "diploid"} for i in range(4)]
# name → (chunk, seq_type, maxcov, ploidy); "deep" has maxcov under the
# depth, so that rows carry sampled read ids; "empty" is the second
# member (no candidate)
CASES = {"diploid": (CHUNK, "ont", 160, "diploid"),
         "haploid": (CHUNK, "ont", 160, "haploid"),
         "deep": (CHUNK, "ul_ont", 24, "diploid"),
         "empty": (MEMBERS[1], "ont", 160, "diploid")}


class Cfg:
    batch_size = 128
    disable_coverage_normalization = False


@pytest.fixture(scope="module")
def snp_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_snp_chunk")
    ref = random_seq(np.random.default_rng(13), L)  # make_fixture's ref
    snps = [(p, BASES[(BASES.index(ref[p]) + 1) % 4],
             ("het1", "het2", "hom")[k % 3])
            for k, p in enumerate([*range(700, 24000, 650),
                                   *range(50700, 99400, 650)])]
    fasta_p, bam_p, _, _ = make_fixture(tmp, seed=13, L=L, depth=30,
                                        read_len=2000, snps=snps,
                                        error_rate=0.01)
    return fasta_p, bam_p


def _build(pkg, fixture, case, dense=False):
    """One side's payload of a case: the JAX package's (pkg "jax") or the
    port's."""
    fasta_p, bam_p = fixture
    chunk, seq_type, maxcov, ploidy = CASES[case]
    if pkg == "jax":
        mod, bam, fasta = j_sf, JBamReader(bam_p), JFastaFile(fasta_p)
    else:
        mod, bam, fasta = p_sf, BamReader(bam_p), FastaFile(fasta_p)
    build = mod.get_snp_candidates if dense else mod.get_snp_chunk_features
    return build(bam, fasta, dict(chunk, ploidy=ploidy), seq_type=seq_type,
                 maxcov=maxcov, ploidy=ploidy)


def _assert_same(got, want):
    assert type(got).__name__ == type(want).__name__
    names = list(want.__dataclass_fields__)
    assert list(got.__dataclass_fields__) == names
    for k in names:
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=k)
            assert a.dtype == b.dtype, k
        else:
            assert a == b, k


@pytest.fixture(scope="module")
def payloads(snp_fixture):
    return {(case, dense): (_build("jax", snp_fixture, case, dense),
                            _build("port", snp_fixture, case, dense))
            for case in CASES for dense in (False, True)}


@pytest.mark.parametrize("dense", [False, True], ids=["chunk", "dense"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_payload_identical(payloads, case, dense):
    want, got = payloads[case, dense]
    _assert_same(got, want)
    assert (len(got) == 0) == (case == "empty")
    if not dense:
        assert (len(got.deep_idx) > 0) == (case == "deep")
        assert isinstance(got, p_sf.SnpChunkFeatures)


@pytest.mark.parametrize("dedup", [True, False])
def test_group_features_identical(snp_fixture, dedup):
    fasta_p, bam_p = snp_fixture
    want = j_sf.get_snp_group_features(JBamReader(bam_p), JFastaFile(fasta_p),
                                       MEMBERS, maxcov=24, dedup=dedup)
    got = p_sf.get_snp_group_features(BamReader(bam_p), FastaFile(fasta_p),
                                      MEMBERS, maxcov=24, dedup=dedup)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert [len(g) == 0 for g in got] == [False, True, False, False]


def test_table_cap_goes_dense(snp_fixture, payloads, monkeypatch):
    """Over _TABLE_CELL_CAP (lowered in both packages under the chunk's
    (S + 1) × N) the chunk goes as its dense SnpBatch, in both packages
    alike and equal to get_snp_candidates'."""
    feats = payloads["diploid", False][1]
    cells = (len(feats.site_ref) + 1) * feats.n_reads
    monkeypatch.setattr(j_sf, "_TABLE_CELL_CAP", cells - 1)
    monkeypatch.setattr(p_sf, "_TABLE_CELL_CAP", cells - 1)
    want = _build("jax", snp_fixture, "diploid")
    got = _build("port", snp_fixture, "diploid")
    assert isinstance(got, p_sf.SnpBatch)
    _assert_same(got, want)
    _assert_same(got, payloads["diploid", True][1])


@pytest.fixture(scope="module")
def states():
    return (J.SnpCallerState.create("ONT-HG002", mesh=None),
            P.SnpCallerState.create("ONT-HG002", device="cpu"))


def _ploidy(case):
    return CASES[case][3]


@pytest.mark.parametrize("case", ["diploid", "haploid", "deep"])
def test_infer_snp_chunk_probabilities(payloads, states, case):
    """K3's twin on the chunk wire against JAX infer_snp_chunk: its fused
    route (no deep row) and its split build + gather + deep route."""
    want_f, got_f = payloads[case, False]
    jstate, pstate = states
    cfgs = [Cfg()]
    if case == "diploid":
        per_row = Cfg()
        per_row.disable_coverage_normalization = True
        cfgs.append(per_row)
    for cfg in cfgs:
        want = J.infer_snp_chunk(jstate, want_f, cfg, _ploidy(case))
        finish = P.infer_snp_chunk(pstate, got_f, cfg, _ploidy(case),
                                   async_mode=True)
        got = finish()
        assert got.shape == want.shape == (len(got_f), 4)
        np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("case", ["diploid", "haploid", "deep"])
def test_infer_snp_batch_probabilities(payloads, states, case):
    want_b, got_b = payloads[case, True]
    jstate, pstate = states
    want = J.infer_snp_batch(jstate, want_b, Cfg(), _ploidy(case))
    got = P.infer_snp_any(pstate, got_b, Cfg(), _ploidy(case))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_empty_chunk_infers_nothing(payloads, states):
    for dense in (False, True):
        feats = payloads["empty", dense][1]
        assert P.infer_snp_any(states[1], feats, Cfg(), "diploid").shape \
            == (0, 4)


def _norm(feats, seed=5):
    return np.random.default_rng(seed).uniform(0.3, 3.0, len(feats)) \
        .astype(np.float32)


def _chunk_x(state, feats, norm, ploidy="diploid"):
    """K3's twin over a chunk's rows (chunk_cohorts), put back in
    candidate order, with the given coverage scale: (x, soc)."""
    B = len(feats)
    x = torch.zeros((B, 5, 41, 5))
    soc = torch.zeros((B, 41), dtype=torch.int32)
    for _deep, args, rows, _r in P.chunk_cohorts(state, feats, Cfg(),
                                                  ploidy):
        args = (*args[:5], torch.from_numpy(norm[rows]), *args[6:])
        xs, ss, _ = K3.snp_pileup(*args)
        x[rows], soc[rows] = xs, ss
    return x, soc


def _dense_x(batch, norm):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return K5.snp_dense_pileup(t(batch.codes), t(batch.read_mask),
                               t(batch.col_ref), t(batch.col_valid),
                               t(batch.center_ref), t(norm))


_select_jit = jax.jit(J._device_select_neighbors, static_argnums=(4,))


@pytest.mark.parametrize("case", ["diploid", "deep"])
def test_chunk_wire_against_jax_per_chunk(payloads, states, case):
    """At full clamps K3's twin selects the columns of the JAX package's
    unclamped _device_select_neighbors, and its x equals the JAX dense
    oracle's (assemble_matrices_np of JAX get_snp_candidates, times the
    scale), which JAX's per-chunk path equals by construction."""
    feats = payloads[case, False][1]
    jbatch = payloads[case, True][0]
    norm = _norm(feats)
    x, soc = _chunk_x(states[1], feats, norm)
    want_soc = np.asarray(_select_jit(
        jnp.asarray(feats.cand_site), jnp.asarray(feats.cand_pos32),
        jnp.asarray(feats.nbr_pos), jnp.asarray(feats.nbr_union),
        feats.seq_type))
    np.testing.assert_array_equal(soc.numpy(), want_soc)
    want = j_sf.assemble_matrices_np(jbatch)
    want[:, 1:, :, :4] *= norm[:, None, None, None]
    np.testing.assert_array_equal(x.numpy(), want)


@pytest.mark.parametrize("case", ["diploid", "deep", "haploid"])
def test_dense_pileup_equals_oracle(payloads, case):
    """K5's twin: x equals assemble_matrices_np times the scale, exactly,
    and ref is the centre-ref one-hot; the wrapper on the CPU counts no
    launch."""
    batch = payloads[case, True][1]
    norm = _norm(batch, 9)
    before = total("k5.launches")
    x, ref = _dense_x(batch, norm)
    assert total("k5.launches") == before
    want = p_sf.assemble_matrices_np(batch)
    want[:, 1:, :, :4] *= norm[:, None, None, None]
    np.testing.assert_array_equal(x.numpy(), want)
    np.testing.assert_array_equal(
        ref.numpy(), np.eye(5, dtype=np.float32)[batch.center_ref][:, :4])
    assert np.abs(want[:, 1:]).sum() > 0


def test_dense_pileup_refuses_bad_inputs(payloads):
    batch = payloads["diploid", True][1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = [t(batch.codes), t(batch.read_mask), t(batch.col_ref),
            t(batch.col_valid), t(batch.center_ref), t(_norm(batch))]
    K5.snp_dense_pileup(*args)  # the good call
    for i, bad, err in ((0, args[0].long(), TypeError),
                        (2, args[2][:-1], ValueError),
                        (5, args[5].double(), TypeError),
                        (1, args[1][:, :-1], ValueError)):
        with pytest.raises(err):
            K5.snp_dense_pileup(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError, match="contiguous"):
        K5.snp_dense_pileup(args[0].transpose(0, 1).contiguous()
                            .transpose(0, 1), *args[1:])


@pytest.mark.parametrize("maxcov", [160, 24])
def test_x_identical_across_routes(snp_fixture, states, maxcov):
    """One member's candidates through the port's three routes: a group
    of one (K3 on the group wire, pileup_cohorts), the chunk wire (K3,
    chunk_cohorts) and the dense batch (K5): torch.equal x, at the
    member's own coverage scale; with maxcov 24 most rows are deep."""
    fasta_p, bam_p = snp_fixture
    member = dict(CHUNK, ploidy="diploid")
    bam, fasta = BamReader(bam_p), FastaFile(fasta_p)
    kw = dict(seq_type="ont", maxcov=maxcov)
    [gf] = p_sf.get_snp_group_payloads(bam, fasta, [member], **kw)
    feats = p_sf.get_snp_chunk_features(bam, fasta, member, **kw)
    batch = p_sf.get_snp_candidates(bam, fasta, member, **kw)
    state = states[1]
    sec = gf.members[0][1]
    B = len(sec)
    assert B == len(feats) == len(batch) > 20
    assert (len(feats.deep_idx) > B // 2) == (maxcov == 24)
    x_group = torch.zeros((B, 5, 41, 5))
    gf.members = [(0, sec)]
    for _p, _deep, args, _mi, js, _r in P.pileup_cohorts(state, gf,
                                                          Cfg()):
        x_group[js] = K3.snp_pileup(*args)[0]
    norm = P._coverage_norm(state, feats, "diploid", Cfg())
    x_chunk, _ = _chunk_x(state, feats, norm)
    x_dense, _ = _dense_x(batch, norm)
    assert torch.equal(x_group, x_chunk) and torch.equal(x_chunk, x_dense)


def test_site_codes_indexed_keys_match_jax(snp_fixture):
    """SiteCodes.indexed_keys against the JAX package's on a chunk
    scan's observations, at the scan's read count and at a wider one."""
    fasta_p, bam_p = snp_fixture
    want = j_sf._scan_chunk(JBamReader(bam_p), JFastaFile(fasta_p), CHUNK)
    got = p_sf._scan_chunk(BamReader(bam_p), FastaFile(fasta_p), CHUNK)
    n = got.rw.n_reads
    assert n > 0 and len(got.sc.rid) > 0
    for width in (n, 2 * n + 1):
        keys = got.sc.indexed_keys(width)
        np.testing.assert_array_equal(keys, want.sc.indexed_keys(width))
        assert np.all(np.diff(keys) > 0)
