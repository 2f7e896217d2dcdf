"""Every indel weight pack through torch_state_dict_from_params into the
port's nn.Modules, against the flax modules of the JAX package on the
same inputs (atol 2e-5, the flax-vs-TF bar of tests/test_models.py)."""

import numpy as np
import pytest
import torch

from nanocaller_tpu.models import HaploidIndelModel as FlaxHaploidIndel
from nanocaller_tpu.models import IndelModel as FlaxIndel
from nanocaller_tpu.models import load_model as flax_load_model
from nanocaller_tpu.models.registry import INDEL_MODEL_NAMES
from nanocaller_tpu_torch.models import (HaploidIndelModel, IndelModel,
                                         load_model,
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
