"""The port's SNP training (nanocaller_tpu_torch/train/{snp_train,data}.py,
the train hooks of models/{snp,weights}.py and SiteCodes.at_pos /
codes_for) against the JAX package on the same seeded inputs:
return_logits against flax's; the weights carried both ways and through
the npz pack that both packages load; the flax-like init; one loss value
and its gradients against JAX's value_and_grad; three Adam updates from
identical gradients against optax.adam; the training examples, shards
and batches array for array; and every SNP case of tests/test_train.py
run on the port with device="cpu" (a falling loss, retraining from the
released pack, the CLI through main(argv))."""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from nanocaller_tpu.io.bam import BamReader as JBamReader
from nanocaller_tpu.io.fasta import FastaFile as JFastaFile
from nanocaller_tpu.io.vcf import VcfReader as JVcfReader
from nanocaller_tpu.models import IndelModel as JIndelModel
from nanocaller_tpu.models import SNPModel as JSNPModel
from nanocaller_tpu.models import load_model as j_load_model
from nanocaller_tpu.models.weights import params_from_npz as j_from_npz
from nanocaller_tpu.pileup.engine import SiteCodes as JSiteCodes
from nanocaller_tpu.pileup.engine import decode_reads as j_decode_reads
from nanocaller_tpu.train import data as JD
from nanocaller_tpu.train.snp_train import joint_accuracy as j_joint_accuracy
from nanocaller_tpu.train.snp_train import snp_loss as j_snp_loss
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile
from nanocaller_tpu_torch.io.vcf import VcfReader
from nanocaller_tpu_torch.models import (IndelModel, SNPModel, init_params,
                                         load_model,
                                         params_from_torch_state_dict,
                                         params_to_npz,
                                         torch_state_dict_from_params)
from nanocaller_tpu_torch.models.weights import params_from_npz
from nanocaller_tpu_torch.pileup.engine import SiteCodes, decode_reads
from nanocaller_tpu_torch.train import data as PD
from nanocaller_tpu_torch.train.snp_train import (joint_accuracy, snp_loss,
                                                  to_device, train_snp_model)
from nanocaller_tpu_torch.train.train_snp import main as train_snp_main

from fixtures import make_fixture
from torch_threads import _torch_threads  # noqa: F401 (autouse)

L = 12000
CHUNK = {"chrom": "chr_t", "start": 1, "end": L}
ATOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def train_fixture(tmp_path_factory):
    """tests/test_train.py's fixture: a 12 kb contig at 30x with its
    planted SNPs in a truth VCF."""
    from nanocaller_tpu.io.vcf import VcfRecord, VcfWriter

    tmp = tmp_path_factory.mktemp("torch_train")
    fasta_p, bam_p, ref_seq, snps = make_fixture(
        tmp, depth=30, L=L, read_len=1200, seed=9, error_rate=0.02)
    vcf_p = str(tmp / "truth.vcf.gz")
    hdr = ["##fileformat=VCFv4.2", "##contig=<ID=chr_t>",
           '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    with VcfWriter(vcf_p, hdr) as w:
        for pos, alt, gt in snps:
            w.write(VcfRecord("chr_t", pos + 1, ref_seq[pos], alt, "50",
                              "PASS", format_="GT",
                              samples=["1/1" if gt == "hom" else "0/1"]))
    return fasta_p, bam_p, vcf_p, snps


@pytest.fixture(scope="module")
def examples(train_fixture):
    """(port, JAX) training examples of the whole fixture, seed 0."""
    fasta_p, bam_p, vcf_p, _ = train_fixture
    out = []
    for mod, bam_c, fa_c, vcf_c in (
            (PD, BamReader, FastaFile, VcfReader),
            (JD, JBamReader, JFastaFile, JVcfReader)):
        truth = mod.truth_snps(vcf_c(vcf_p), "chr_t", 1, L)
        out.append(mod.generate_snp_training_examples(
            bam_c(bam_p), fa_c(fasta_p), truth, CHUNK, mincov=8))
    return out


def _random_batch(seed, B=16):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(B, 5, 41, 5)).astype(np.float32),
            "ref": np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)],
            "base_labels": np.eye(2, dtype=np.float32)[
                rng.integers(0, 2, (B, 4))],
            "gt_label": np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]}


def _jax_params(model, seed, *example):
    return jax.tree.map(np.asarray,
                        model.init(jax.random.PRNGKey(seed), *example))


def _port_model(cls, params):
    m = cls()
    m.load_state_dict(torch_state_dict_from_params(params))
    return m


def _assert_trees_close(got, want, rtol, atol):
    assert got["params"].keys() == want["params"].keys()
    for layer, vars_ in want["params"].items():
        assert got["params"][layer].keys() == vars_.keys(), layer
        for var, w in vars_.items():
            np.testing.assert_allclose(got["params"][layer][var],
                                       np.asarray(w), rtol=rtol, atol=atol,
                                       err_msg="%s/%s" % (layer, var))


@pytest.mark.parametrize("source", ["init", "ONT-HG002"])
def test_return_logits_matches_flax(source):
    b = _random_batch(1, B=32)
    jm = JSNPModel()
    params = _jax_params(jm, 3, b["x"][:1], b["ref"][:1]) \
        if source == "init" else j_load_model("snp", source)[0]
    m = _port_model(SNPModel, params)
    with torch.no_grad():
        got = m(torch.from_numpy(b["x"]), torch.from_numpy(b["ref"]),
                return_logits=True)
        probs = m(torch.from_numpy(b["x"]), torch.from_numpy(b["ref"]))
    want = jm.apply(params, b["x"], b["ref"], return_logits=True)
    want_p = jm.apply(params, b["x"], b["ref"])
    for g, w in zip(got + probs, want + want_p):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("kind", ["snp", "indel"])
def test_params_carry_both_ways(kind, tmp_path):
    """flax tree → torch state_dict → flax tree is exact, and a pack the
    port writes loads exactly through both packages' loaders."""
    if kind == "snp":
        params = j_load_model("snp", "ONT-HG002")[0]
        cls = SNPModel
    else:
        params = j_load_model("indel", "ONT-HG002")[0]
        cls = IndelModel
    back = params_from_torch_state_dict(_port_model(cls, params)
                                        .state_dict())
    _assert_trees_close(back, params, 0, 0)
    path = params_to_npz(str(tmp_path / ("%s.npz" % kind)), back)
    for loaded in (params_from_npz(path), j_from_npz(path),
                   load_model(kind, path)[0], j_load_model(kind, path)[0]):
        _assert_trees_close(loaded, params, 0, 0)


@pytest.mark.parametrize("cls,jcls,shape", [
    (SNPModel, JSNPModel, (1, 5, 41, 5)),
    (IndelModel, JIndelModel, (1, 15, 128, 2))])
def test_init_params_like_flax(cls, jcls, shape):
    """lecun_normal weights (truncated at ±2σ, variance 1/fan_in) and zero
    biases, from the generator's seed: the distributions of a flax
    init, not its draws."""
    a = init_params(cls(), torch.Generator().manual_seed(0))
    b = init_params(cls(), torch.Generator().manual_seed(0))
    c = init_params(cls(), torch.Generator().manual_seed(1))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert not torch.equal(a.state_dict()["fc1.weight"],
                           c.state_dict()["fc1.weight"])
    x = np.zeros(shape, np.float32)
    args = (x, np.zeros((1, 4), np.float32)) if cls is SNPModel else (x,)
    flax = _jax_params(jcls(), 0, *args)["params"]
    for name, p in a.state_dict().items():
        layer, var = name.rsplit(".", 1)
        if var == "bias":
            assert not p.any(), name
            continue
        fan_in = p[0].numel()
        sigma = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = p.numpy()
        assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6), name
        fw = np.asarray(flax[layer]["kernel"])
        assert fw.size == w.size
        if w.size >= 10000:  # the sample std of a large layer
            want = np.sqrt(1.0 / fan_in)
            assert abs(w.std() / want - 1) < 0.03, name
            assert abs(fw.std() / want - 1) < 0.03, name


@pytest.mark.parametrize("source", ["init", "ONT-HG002"])
def test_snp_loss_and_grads_match_jax(source):
    b = _random_batch(5)
    jm = JSNPModel()
    params = _jax_params(jm, 7, b["x"][:1], b["ref"][:1]) \
        if source == "init" else j_load_model("snp", source)[0]
    want, jgrads = jax.value_and_grad(
        lambda p: j_snp_loss(jm, p, b))(params)
    m = _port_model(SNPModel, params)
    loss = snp_loss(m, to_device(b, "cpu"))
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= ATOL
    grads = params_from_torch_state_dict(
        {n: p.grad for n, p in m.named_parameters()})
    _assert_trees_close(grads, jgrads, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("cls,jcls,shape", [
    (SNPModel, JSNPModel, (1, 5, 41, 5)),
    (IndelModel, JIndelModel, (1, 15, 128, 2))])
def test_adam_matches_optax(cls, jcls, shape):
    """Three torch.optim.Adam(lr) updates from the same gradients as three
    optax.adam(lr) updates (the gradients are given, so Adam's first-step
    sign amplification of gradient noise stays out of it)."""
    x = np.zeros(shape, np.float32)
    args = (x, np.zeros((1, 4), np.float32)) if cls is SNPModel else (x,)
    params = _jax_params(jcls(), 2, *args)
    m = _port_model(cls, params)
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    tx = optax.adam(1e-3)
    state = tx.init(params)
    rng = np.random.default_rng(11)
    for _ in range(3):
        g = jax.tree.map(
            lambda a: rng.normal(scale=0.1, size=a.shape).astype(np.float32),
            params)
        updates, state = tx.update(g, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params,
                                                              updates))
        tg = torch_state_dict_from_params(g)
        for n, p in m.named_parameters():
            p.grad = tg[n].clone()
        opt.step()
    _assert_trees_close(params_from_torch_state_dict(m.state_dict()),
                        params, 0, 1e-7)


def test_site_codes_lookups_match_jax(train_fixture):
    _, bam_p, _, snps = train_fixture
    sites = np.array(sorted({p for p, _, _ in snps} | {100, 5000}), np.int64)
    sc = SiteCodes(decode_reads(BamReader(bam_p), "chr_t", 0, L), sites)
    jsc = JSiteCodes(j_decode_reads(JBamReader(bam_p), "chr_t", 0, L),
                     sites)
    rids = np.arange(0, 400, 3, dtype=np.int32)
    for i, p in enumerate(sites):
        for got, want in zip(sc.at_pos(p), jsc.at_pos(p)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(sc.codes_for(i, rids),
                                      jsc.codes_for(i, rids))
    assert [len(a) for a in sc.at_pos(101)] == [0, 0]


def test_truth_snps_match_jax(train_fixture):
    _, _, vcf_p, snps = train_fixture
    got = PD.truth_snps(VcfReader(vcf_p), "chr_t", 1, L)
    assert got == JD.truth_snps(JVcfReader(vcf_p), "chr_t", 1, L)
    assert len(got) == len(snps)
    for pos, _alt, gt in snps:
        assert got[pos][0] == (0 if gt == "hom" else 1)


def test_examples_match_jax(examples):
    """Every array of generate_snp_training_examples, exactly, with each
    truth site present and ref-labelled negatives (test_train.py's
    checks)."""
    got, want = examples
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["x"].shape[1:] == (5, 41, 5) and len(got["x"]) > 0
    negs = [i for i, p in enumerate(got["pos"])
            if got["gt"][i] == 0 and got["allele1"][i] == got["ref"][i]
            == got["allele2"][i]]
    assert negs


def test_shards_round_trip_both_ways(examples, tmp_path):
    got, _ = examples
    p = PD.save_shard(str(tmp_path / "shard0.npz"), got)
    half = {k: v[: len(v) // 2] for k, v in got.items()}
    q = PD.save_shard(str(tmp_path / "shard1.npz"), half)
    for back in (PD.load_shards([p, q]), JD.load_shards([p, q]),
                 PD.load_shards(str(tmp_path / "shard*.npz"))):
        for k in got:
            np.testing.assert_array_equal(
                back[k], np.concatenate([got[k], half[k]]), err_msg=k)
    empty = PD.load_shards([])
    assert all(len(v) == 0 for v in empty.values())


@pytest.mark.parametrize("batch_size", [8, 37])
def test_batches_match_jax(examples, batch_size):
    got, _ = examples
    a = list(PD.batches_from_examples(got, batch_size,
                                      np.random.default_rng(4)))
    b = list(JD.batches_from_examples(got, batch_size,
                                      np.random.default_rng(4)))
    assert len(a) == len(b) == len(got["gt"]) // batch_size
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert a[0]["x"].shape == (batch_size, 5, 41, 5)
    np.testing.assert_array_equal(a[0]["base_labels"].sum(-1), 1.0)


def test_joint_accuracy_matches_jax(examples):
    got, _ = examples
    params = j_load_model("snp", "ONT-HG002")[0]
    m = _port_model(SNPModel, params)
    for b in PD.batches_from_examples(got, 16, np.random.default_rng(0)):
        assert joint_accuracy(m, to_device(b, "cpu")) == \
            int(j_joint_accuracy(JSNPModel(), params, b))


def test_snp_training_reduces_loss(examples, tmp_path):
    """test_train.py's case on the port: three epochs lower the loss; the
    last checkpoint loads through both packages' load_model, and the JAX
    forward on it equals the port's."""
    got, _ = examples
    params, history = train_snp_model(
        got, got, str(tmp_path / "ckpt"), epochs=3, batch_size=16,
        log=lambda *a: None, device="cpu")
    assert [h["epoch"] for h in history] == [1, 2, 3]
    assert history[-1]["loss"] < history[0]["loss"]
    assert history[-1]["val_acc"] is not None
    ckpt = history[-1]["ckpt"]
    p, cov = load_model("snp", ckpt)
    jp, jcov = j_load_model("snp", ckpt)
    assert cov == jcov == 0.0
    _assert_trees_close(p, params, 0, 0)
    b = _random_batch(2, B=8)
    with torch.no_grad():
        probs, gt = _port_model(SNPModel, p)(torch.from_numpy(b["x"]),
                                             torch.from_numpy(b["ref"]))
    jprobs, jgt = JSNPModel().apply(jp, b["x"], b["ref"])
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=ATOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), atol=ATOL)


def test_retrain_from_released_weights(examples, tmp_path):
    got, _ = examples
    init, _ = load_model("snp", "ONT-HG002")
    params, history = train_snp_model(
        got, None, str(tmp_path / "rt"), epochs=1, batch_size=16,
        init_params=init, log=lambda *a: None, device="cpu")
    assert history[0]["loss"] is not None and history[0]["val_acc"] is None
    # one epoch of small Adam steps from the pack: moved, but near it
    moved = [np.abs(params["params"][k]["kernel"]
                    - init["params"][k]["kernel"]).max()
             for k in init["params"]]
    assert 0 < max(moved) < 0.1


def test_train_cli_end_to_end(train_fixture, tmp_path):
    """The port's train_snp CLI through main(argv), as test_train.py
    drives tools/train_snp.py: feature generation → training →
    checkpoints with their .coverage sidecars, loadable by inference."""
    fasta_p, bam_p, vcf_p, _ = train_fixture
    history = train_snp_main([
        "--bam", bam_p, "--ref", fasta_p, "--truth_vcf", vcf_p,
        "--regions", "chr_t:1-12000", "--output", str(tmp_path / "cli"),
        "--epochs", "2", "--batch_size", "16", "--val_every", "2",
        "--chunk_size", "6000", "--train_coverage", "30",
        "--device", "cpu"])
    assert len(history) == 2
    ckpt = history[-1]["ckpt"]
    assert os.path.exists(ckpt)
    assert os.path.exists(ckpt.replace(".npz", ".coverage"))
    assert load_model("snp", ckpt)[1] == j_load_model("snp", ckpt)[1] == 30.0
