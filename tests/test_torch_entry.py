"""The port's entry module (nanocaller_tpu_torch/entry.py) against the JAX
package's __graft_entry__.py: _example_batch's payload against the
logical half of JAX's (the same draws, unpadded), entry()'s forward
against the JAX entry fn on the same payload (atol 2e-5), and the dry
run on the CPU: the three steps of dryrun_multichip(1), and the real
pipeline over two CPU replicas against one device, byte for byte."""

import numpy as np

import __graft_entry__ as GE
from nanocaller_tpu_torch import entry as PE
from nanocaller_tpu_torch.runtime import sharding

from torch_threads import _torch_threads  # noqa: F401 (autouse)

B = 64


def test_example_batch_is_the_jax_payload():
    feats = PE._example_batch(B=B)
    (read_lo, read_hi, site_ref, site_major, site_minor, minor_bits,
     exc_packed, exc_indptr, e_real, hole_site, hole_rid, nbr_pos,
     nbr_union, cand_site, cand_pos, norm) = GE._example_batch(B=B)
    S, N, E = len(feats.site_ref), feats.n_reads, int(e_real)
    assert (S, N, len(feats)) == (B * 3 // 2, 4800, B)
    for got, want in (
            (feats.read_lo, read_lo[:N]), (feats.read_hi, read_hi[:N]),
            (feats.site_ref, site_ref[:S]), (feats.site_major,
                                             site_major[:S]),
            (feats.site_minor, site_minor[:S]), (feats.minor_bits,
                                                 minor_bits),
            (feats.exc_packed, exc_packed[:E]),
            (feats.exc_indptr, exc_indptr[:S + 1]),
            (feats.nbr_pos, nbr_pos[:S]), (feats.nbr_union, nbr_union[:S]),
            (feats.cand_site, cand_site), (feats.cand_pos32, cand_pos)):
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))
    assert len(hole_site) == len(hole_rid) == len(feats.hole_site) == 0
    assert np.all(norm == 1.0)


def test_entry_matches_jax_entry():
    """K3's twin on the chunk wire and the SNP CNN, through
    snp_caller.infer_snp_chunk, against JAX's fused forward."""
    fn, args = PE.entry(device="cpu", B=B)
    got = fn(*args)
    jfn, _ = GE.entry()
    want = np.asarray(jfn(*GE._example_batch(B=B)))
    assert got.shape == want.shape == (B, 4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_dryrun_multichip_on_one_cpu_process():
    """The sharded train step (one Gloo rank), the sharded inference and
    the real --mode all --cpu 2 pipeline, whose VCFs carry calls."""
    PE.dryrun_multichip(1, device="cpu")


def test_dryrun_pipeline_two_replicas_match_one(monkeypatch):
    """Two CPU replicas stand in for two cards: the pipeline splits its
    CNN batches over them, and the rerun on one device writes the same
    VCF bytes."""
    import torch

    monkeypatch.setattr(sharding, "inference_devices",
                        lambda device="cuda": [torch.device("cpu")] * 2)
    calls = PE._dryrun_real_pipeline(device="cpu")
    assert min(calls.values()) > 0
