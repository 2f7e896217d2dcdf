"""The port's indel training (nanocaller_tpu_torch/train/{indel_train,
indel_data}.py and preset_variants in pileup/indel_features.py) against
the JAX package on the same seeded inputs: one indel_loss value and its
gradients against JAX's value_and_grad (the clip's gradient at its bounds
too); truth_indels and generate_indel_training_examples(device="cpu")
against JAX's use_device_alignment=False path, exactly (the plain twins
of K1/K2/K4 give nw_align's cigars); preset_variants=None leaving the
calling path's candidates unchanged; label_candidates_from_truth; and
the indel cases of tests/test_train.py run on the port with
device="cpu" (training, features then training, the CLI through
main(argv))."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanocaller_tpu.io.bam import BamReader as JBamReader
from nanocaller_tpu.io.fasta import FastaFile as JFastaFile
from nanocaller_tpu.io.vcf import VcfReader as JVcfReader
from nanocaller_tpu.models import IndelModel as JIndelModel
from nanocaller_tpu.models import load_model as j_load_model
from nanocaller_tpu.train import indel_data as JID
from nanocaller_tpu.train.indel_train import indel_loss as j_indel_loss
from nanocaller_tpu.train.indel_train import \
    label_candidates_from_truth as j_label
from nanocaller_tpu_torch.io.bam import BamReader
from nanocaller_tpu_torch.io.fasta import FastaFile
from nanocaller_tpu_torch.io.vcf import VcfReader
from nanocaller_tpu_torch.models import (IndelModel, load_model,
                                         params_from_torch_state_dict,
                                         torch_state_dict_from_params)
from nanocaller_tpu_torch.pileup.indel_features import get_indel_candidates
from nanocaller_tpu_torch.train import indel_data as PID
from nanocaller_tpu_torch.train.indel_train import (
    indel_loss, label_candidates_from_truth, train_indel_model)
from nanocaller_tpu_torch.train.train_indel import main as train_indel_main

from fixtures import make_fixture
from torch_threads import _torch_threads  # noqa: F401 (autouse)

ATOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
INDELS = [(1500, "del", 6, "het1"), (3000, "ins", "TTTTT", "hom")]


def _truth_vcf(path, ref_seq):
    from nanocaller_tpu.io.vcf import VcfRecord, VcfWriter

    hdr = ["##fileformat=VCFv4.2", "##contig=<ID=chr_t>",
           '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    with VcfWriter(path, hdr) as w:
        w.write(VcfRecord("chr_t", 1501, ref_seq[1500:1507], ref_seq[1500],
                          "50", "PASS", format_="GT", samples=["0/1"]))
        w.write(VcfRecord("chr_t", 3001, ref_seq[3000],
                          ref_seq[3000] + "TTTTT", "50", "PASS",
                          format_="GT", samples=["1/1"]))
    return path


@pytest.fixture(scope="module")
def indel_fixture(tmp_path_factory):
    """tests/test_train.py's indel fixture: a haplotagged 5 kb contig at
    36x with a het deletion and a hom insertion, and their truth VCF."""
    tmp = tmp_path_factory.mktemp("torch_train_indel")
    fasta_p, bam_p, ref_seq, _ = make_fixture(
        tmp, depth=36, L=5000, read_len=900, seed=21, snps=[],
        indels=INDELS, tag_haplotypes=True)
    return fasta_p, bam_p, _truth_vcf(str(tmp / "truth.vcf.gz"), ref_seq)


def _random_batch(seed, B=16):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(B, 15, 128, 2)).astype(np.float32),
            "label": np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]}


@pytest.mark.parametrize("source", ["init", "ONT-HG002"])
def test_indel_loss_and_grads_match_jax(source):
    b = _random_batch(3)
    jm = JIndelModel()
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4),
                                              b["x"][:1])) \
        if source == "init" else j_load_model("indel", source)[0]
    want, jgrads = jax.value_and_grad(
        lambda p: j_indel_loss(jm, p, b))(params)
    m = IndelModel()
    m.load_state_dict(torch_state_dict_from_params(params))
    loss = indel_loss(m, {k: torch.from_numpy(v) for k, v in b.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= ATOL
    grads = params_from_torch_state_dict(
        {n: p.grad for n, p in m.named_parameters()})
    for layer, vars_ in jgrads["params"].items():
        for var, w in vars_.items():
            np.testing.assert_allclose(
                grads["params"][layer][var], np.asarray(w), rtol=GRAD_RTOL,
                atol=GRAD_ATOL, err_msg="%s/%s" % (layer, var))


def test_probability_clip_gradient_matches_jnp_clip():
    """The loss clips the probabilities as jnp.clip does, gradient
    included: half of it where a probability sits on a bound."""
    p = np.array([[1.0, 0.0, 0.0, 0.0], [0.5, 0.25, 1e-9, 0.25]],
                 np.float32)
    lab = np.eye(4, dtype=np.float32)[[0, 2]]

    def j_ce(q):
        return -(lab * jnp.log(jnp.clip(q, 1e-9, 1.0))).sum(-1).mean()

    want = np.asarray(jax.grad(j_ce)(p))

    class Fixed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.q = torch.nn.Parameter(torch.from_numpy(p.copy()))

        def forward(self, x):
            return self.q

    m = Fixed()
    indel_loss(m, {"x": None, "label": torch.from_numpy(lab)}).backward()
    np.testing.assert_allclose(m.q.grad.numpy(), want, rtol=1e-6)


def test_truth_indels_match_jax(indel_fixture):
    _, _, vcf_p = indel_fixture
    got = PID.truth_indels(VcfReader(vcf_p), "chr_t", 1, 5000)
    assert got == JID.truth_indels(JVcfReader(vcf_p), "chr_t", 1, 5000)
    assert got == {1500: 2, 3000: 1}


@pytest.mark.parametrize("seq_type,seed", [("ont", 0), ("pacbio", 3)])
def test_indel_examples_match_jax(indel_fixture, seq_type, seed):
    """generate_indel_training_examples on the port's CPU path (the twins
    of K1/K2/K4) equals JAX's host path array for array."""
    fasta_p, bam_p, vcf_p = indel_fixture
    chunk = {"chrom": "chr_t", "start": 1, "end": 5000}
    truth = PID.truth_indels(VcfReader(vcf_p), "chr_t", 1, 5000)
    got = PID.generate_indel_training_examples(
        BamReader(bam_p), FastaFile(fasta_p), truth, chunk,
        seq_type=seq_type, seed=seed, device="cpu")
    want = JID.generate_indel_training_examples(
        JBamReader(bam_p), JFastaFile(fasta_p), truth, chunk,
        seq_type=seq_type, seed=seed, use_device_alignment=False)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    x, labels, _pos = got
    assert x.shape[1:] == (15, 128, 2) and len(x) == len(labels) > 0
    assert 2 in labels and 1 in labels


def test_preset_variants_none_keeps_the_scan(indel_fixture):
    """preset_variants=None is the calling path: the same candidates and
    tensors as before; given anchors, exactly those are tensorized."""
    fasta_p, bam_p, _ = indel_fixture
    chunk = {"chrom": "chr_t", "start": 1, "end": 5000}
    scan = get_indel_candidates(BamReader(bam_p), FastaFile(fasta_p), chunk,
                                device="cpu")
    none = get_indel_candidates(BamReader(bam_p), FastaFile(fasta_p), chunk,
                                preset_variants=None, device="cpu")
    assert list(scan.pos) == list(none.pos) and len(scan.pos)
    for a in ("x0", "x1", "x2"):
        np.testing.assert_array_equal(getattr(scan, a), getattr(none, a))
    anchors = {int(p) - 1: 1 for p in scan.pos}
    anchors[1000] = 0
    preset = get_indel_candidates(BamReader(bam_p), FastaFile(fasta_p),
                                  chunk, preset_variants=anchors,
                                  device="cpu")
    assert set(preset.pos) <= {p + 1 for p in anchors}
    assert set(scan.pos) <= set(preset.pos)


def test_label_candidates_match_jax():
    class FakeBatch:
        pos = [100, 205, 300, 88, 112]

        def __len__(self):
            return len(self.pos)

    truth = {102: 3, 210: 1}
    got = label_candidates_from_truth(FakeBatch(), truth)
    assert got.tolist() == j_label(FakeBatch(), truth).tolist()
    assert got.tolist() == [3, 1, 0, 0, 3]
    assert label_candidates_from_truth(FakeBatch(), {}).tolist() == [0] * 5


def test_indel_training_reduces_loss(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 15, 128, 2)).astype(np.float32)
    labels = rng.integers(0, 4, 64)
    params, history = train_indel_model(
        x, labels, str(tmp_path / "ic"), epochs=3, batch_size=16,
        log=lambda *a: None, device="cpu")
    assert history[-1]["loss"] < history[0]["loss"]
    p, _ = load_model("indel", history[-1]["ckpt"])
    jp, _ = j_load_model("indel", history[-1]["ckpt"])
    m = IndelModel()
    m.load_state_dict(torch_state_dict_from_params(p))
    with torch.no_grad():
        probs = m(torch.from_numpy(x[:8])).numpy()
    np.testing.assert_allclose(probs, np.asarray(JIndelModel().apply(
        jp, x[:8])), atol=ATOL)


def test_indel_features_then_training(indel_fixture, tmp_path):
    fasta_p, bam_p, vcf_p = indel_fixture
    truth = PID.truth_indels(VcfReader(vcf_p), "chr_t", 1, 5000)
    x, labels, _ = PID.generate_indel_training_examples(
        BamReader(bam_p), FastaFile(fasta_p), truth,
        {"chrom": "chr_t", "start": 1, "end": 5000}, device="cpu")
    init, _ = load_model("indel", "ONT-HG002")
    params, history = train_indel_model(
        x, labels, str(tmp_path / "ick"), epochs=2,
        batch_size=min(8, len(x)), init_params=init, log=lambda *a: None,
        device="cpu")
    assert history[-1]["loss"] is not None and len(history) == 2


def test_indel_train_cli(tmp_path):
    fasta_p, bam_p, ref_seq, _ = make_fixture(
        tmp_path, depth=30, L=5000, read_len=900, seed=23, snps=[],
        indels=INDELS, tag_haplotypes=True)
    vcf_p = _truth_vcf(str(tmp_path / "ti.vcf.gz"), ref_seq)
    history = train_indel_main([
        "--bam", bam_p, "--ref", fasta_p, "--truth_vcf", vcf_p,
        "--regions", "chr_t:1-5000", "--output", str(tmp_path / "iout"),
        "--epochs", "2", "--batch_size", "8", "--device", "cpu"])
    assert history and os.path.exists(history[-1]["ckpt"])
    assert len(history) == 2
