"""In-process data parallelism (nanocaller_tpu_torch/runtime/sharding.py)
changes nothing observable: the counterpart of
tests/test_sharded_inference.py. With sharding.inference_devices
monkeypatched to two CPU replicas, the SNP group, chunk and dense routes
and the indel CNN split their rows over the replicas in cfg.batch_size
slices (one kernel launch a replica), and their probabilities are
bit-identical to one device's; call_snps writes the same VCF bytes."""

import gzip

import numpy as np
import pytest
import torch

from nanocaller_tpu_torch import indel_caller as PI
from nanocaller_tpu_torch import snp_caller as P
from nanocaller_tpu_torch.config import Config
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile
from nanocaller_tpu_torch.pileup import snp_features as p_sf
from nanocaller_tpu_torch.runtime import sharding
from nanocaller_tpu_torch.runtime.chunker import get_chunks, get_regions_list

from fixtures import BASES, make_fixture, random_seq
from torch_threads import _torch_threads  # noqa: F401 (autouse)

L = 60_000
TWO = [torch.device("cpu"), torch.device("cpu")]
MEMBERS = [{"chrom": "chr_t", "start": 1 + i * 20000, "end": (i + 1) * 20000,
            "ploidy": "diploid"} for i in range(3)]


class Cfg:
    # small per-device batches so that every route's rows spread over
    # both replicas
    batch_size = 16
    disable_coverage_normalization = False


@pytest.fixture(scope="module")
def snp_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_sharded")
    ref = random_seq(np.random.default_rng(17), L)  # make_fixture's ref
    snps = [(p, BASES[(BASES.index(ref[p]) + 1) % 4],
             ("het1", "het2", "hom")[k % 3])
            for k, p in enumerate(range(700, L - 700, 400))]
    fasta_p, bam_p, _, _ = make_fixture(tmp, seed=17, L=L, depth=30,
                                        read_len=2000, snps=snps,
                                        error_rate=0.01)
    return fasta_p, bam_p


@pytest.fixture(scope="module")
def states():
    one = P.SnpCallerState.create("ONT-HG002", device="cpu")
    two = P.SnpCallerState.create("ONT-HG002", device="cpu", devices=TWO)
    return one, two


def test_devices_and_rows():
    assert sharding.inference_devices("cpu") is None
    assert sharding.inference_devices("cuda:0") is None
    assert sharding.dp_scale(16, None) == 16
    assert sharding.dp_scale(16, TWO) == 32
    rows = sharding.dp_rows(70, 16, TWO)
    assert [r.tolist() for r in rows] == [
        [*range(0, 16), *range(32, 48), *range(64, 70)],
        [*range(16, 32), *range(48, 64)]]
    assert [r.tolist() for r in sharding.dp_rows(5, 16, None)] == \
        [list(range(5))]
    one = P.SnpCallerState.create("ONT-HG002", device="cpu")
    assert len(one.replicas) == 1 and one.replicas[0][1] is one.model


@pytest.mark.parametrize("maxcov", [160, 24], ids=["normal", "deep"])
@pytest.mark.parametrize("ploidy", ["diploid", "haploid"])
def test_group_route_bit_identical(snp_fixture, states, ploidy, maxcov):
    fasta_p, bam_p = snp_fixture
    [gf] = p_sf.get_snp_group_payloads(
        BamReader(bam_p), FastaFile(fasta_p),
        [dict(m, ploidy=ploidy) for m in MEMBERS], maxcov=maxcov)
    gf.members = [(i, sec) for i, (_m, sec) in enumerate(gf.members)]
    assert (sum(len(s.deep_idx) for _, s in gf.members) > 0) == \
        (maxcov == 24)
    launches = P.pileup_cohorts(states[1], gf, Cfg())
    assert {r for *_, r in launches} == {0, 1}
    want = P.infer_snp_group(states[0], gf, Cfg())
    got = P.infer_snp_group(states[1], gf, Cfg())
    assert sum(len(w) for w in want) > 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("maxcov", [160, 24], ids=["normal", "deep"])
@pytest.mark.parametrize("dense", [False, True], ids=["chunk", "dense"])
def test_chunk_and_dense_routes_bit_identical(snp_fixture, states, dense,
                                              maxcov):
    fasta_p, bam_p = snp_fixture
    build = p_sf.get_snp_candidates if dense else p_sf.get_snp_chunk_features
    feats = build(BamReader(bam_p), FastaFile(fasta_p), MEMBERS[0],
                  maxcov=maxcov)
    assert len(feats) > 2 * Cfg.batch_size
    if not dense:
        assert (len(feats.deep_idx) > 0) == (maxcov == 24)
        assert {r for *_, r in P.chunk_cohorts(states[1], feats, Cfg(),
                                               "diploid")} == {0, 1}
    for ploidy in ("diploid", "haploid"):
        np.testing.assert_array_equal(
            P.infer_snp_any(states[1], feats, Cfg(), ploidy),
            P.infer_snp_any(states[0], feats, Cfg(), ploidy))


def test_indel_probs_bit_identical():
    rng = np.random.default_rng(5)

    class _B:
        x0, x1, x2 = (rng.random((13, 5, 128, 2)).astype(np.float32)
                      for _ in range(3))

        def __len__(self):
            return 13

    class _H:
        x = rng.random((13, 5, 128, 2)).astype(np.float32)

        def __len__(self):
            return 13

    one = PI.IndelCallerState.create("ONT-HG002", device="cpu",
                                     devices=None)
    two = PI.IndelCallerState.create("ONT-HG002", device="cpu",
                                     devices=TWO)
    assert len(one.replicas) == 1 and len(two.replicas) == 2
    np.testing.assert_array_equal(
        PI.infer_indel_batch(two, _B(), batch_size=4),
        PI.infer_indel_batch(one, _B(), batch_size=4))
    np.testing.assert_array_equal(
        PI.infer_haploid_indel_batch(two, _H(), batch_size=4),
        PI.infer_haploid_indel_batch(one, _H(), batch_size=4))
    got = PI.infer_indel_many(two, [_B(), _B()], batch_size=4)
    want = PI.infer_indel_many(one, [_B(), _B()], batch_size=4)
    assert [g.shape for g in got] == [(13, 4), (13, 4)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_call_snps_vcf_identical(snp_fixture, tmp_path, monkeypatch):
    fasta_p, bam_p = snp_fixture
    cfg = Config(bam=bam_p, ref=fasta_p, sample="S", prefix="t",
                 snp_model="ONT-HG002", batch_size=16, device="cpu")
    bam = BamReader(bam_p)
    regions = get_regions_list(cfg, bam)
    chunks = get_chunks(regions, 1)
    outs = []
    for tag, devices in (("single", None), ("two", TWO)):
        monkeypatch.setattr(sharding, "inference_devices",
                            lambda _dev, d=devices: d)
        (tmp_path / tag).mkdir()
        outs.append(P.call_snps(cfg, bam, regions, chunks,
                                str(tmp_path / tag)))
    data = []
    for path in outs:
        for p in (path, path.replace(".snps.", ".unfiltered.snps.")):
            with gzip.open(p) as fh:
                data.append(fh.read())
    assert data[:2] == data[2:]
    assert data[0].count(b"\tPASS\t") > 50
