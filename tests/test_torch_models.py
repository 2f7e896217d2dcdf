"""Every indel and SNP weight pack through torch_state_dict_from_params
into the port's nn.Modules, against the flax modules of the JAX package on the
same inputs (atol 2e-5, the flax-vs-TF bar of tests/test_models.py)."""

import numpy as np
import pytest
import torch

from nanocaller_tpu.models import HaploidIndelModel as FlaxHaploidIndel
from nanocaller_tpu.models import HaploidSNPModel as FlaxHaploidSNP
from nanocaller_tpu.models import IndelModel as FlaxIndel
from nanocaller_tpu.models import SNPModel as FlaxSNP
from nanocaller_tpu.models import load_model as flax_load_model
from nanocaller_tpu.models.registry import INDEL_MODEL_NAMES, SNP_MODEL_NAMES
from nanocaller_tpu_torch.models import (HaploidIndelModel,
                                         HaploidSNPModel, IndelModel,
                                         SNPModel, load_model,
                                         torch_state_dict_from_params)

from torch_threads import _torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", INDEL_MODEL_NAMES)
def test_indel_pack_matches_flax(name):
    haploid = name == "haploid"
    rows = 5 if haploid else 15
    rng = np.random.default_rng(INDEL_MODEL_NAMES.index(name))
    x = (rng.normal(size=(6, rows, 128, 2)) * 0.7).astype(np.float32)
    fparams, _ = flax_load_model("indel", name)
    want = np.asarray((FlaxHaploidIndel() if haploid else FlaxIndel())
                      .apply(fparams, x))
    params, _ = load_model("indel", name)
    model = HaploidIndelModel() if haploid else IndelModel()
    model.load_state_dict(torch_state_dict_from_params(params))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, 1 if haploid else 4)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_state_dict_layouts():
    params, _ = load_model("indel", "ONT-HG002")
    sd = torch_state_dict_from_params(params)
    k = params["params"]["conv1_3"]["kernel"]  # HWIO
    assert tuple(sd["conv1_3.weight"].shape) == (k.shape[3], k.shape[2],
                                                 k.shape[0], k.shape[1])
    assert tuple(sd["fc1.weight"].shape) == (32, 13 * 31 * 48)
    np.testing.assert_array_equal(sd["fc2.weight"].numpy(),
                                  params["params"]["fc2"]["kernel"].T)


SNP_PACKS = [n for n in SNP_MODEL_NAMES if n != "haploid"]


def _snp_inputs(rng, B=6):
    """Pileup-like inputs: signed counts scaled as after normalisation,
    the ref row 0/1, and a one-hot ref base."""
    x = (rng.integers(-30, 31, (B, 5, 41, 5)) * 0.8).astype(np.float32)
    x[:, 0] = rng.integers(0, 2, (B, 41, 5)).astype(np.float32)
    ref = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    return x, ref


@pytest.mark.parametrize("name", SNP_PACKS)
def test_snp_pack_matches_flax(name):
    rng = np.random.default_rng(100 + SNP_MODEL_NAMES.index(name))
    x, ref = _snp_inputs(rng)
    fparams, _ = flax_load_model("snp", name)
    want_p, want_gt = FlaxSNP().apply(fparams, x, ref)
    params, _ = load_model("snp", name)
    model = SNPModel()
    model.load_state_dict(torch_state_dict_from_params(params))
    with torch.inference_mode():
        got_p, got_gt = model.eval()(torch.from_numpy(x),
                                     torch.from_numpy(ref))
    assert got_p.shape == (6, 4, 2) and got_gt.shape == (6, 2)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=2e-5)
    np.testing.assert_allclose(got_gt.numpy(), np.asarray(want_gt),
                               atol=2e-5)


def test_haploid_snp_pack_matches_flax():
    rng = np.random.default_rng(99)
    x, ref = _snp_inputs(rng)
    fparams, _ = flax_load_model("snp", "haploid")
    want = np.asarray(FlaxHaploidSNP().apply(fparams, x, ref))
    params, _ = load_model("snp", "haploid")
    model = HaploidSNPModel()
    model.load_state_dict(torch_state_dict_from_params(params))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(ref))
    assert got.shape == want.shape == (6, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
