"""The port's sharded SNP train step and inference demo
(nanocaller_tpu_torch/runtime/sharding.py) against the JAX package's
(nanocaller_tpu/runtime/sharding.py) on the 8 CPU devices that
tests/conftest.py forces: make_mesh's grids, snp_param_shardings' slices
rank by rank, one step at (dp=2, mdl=2) in four spawned Gloo processes
against the JAX step on make_mesh(4, dp=2) and against the port's
unsharded step (loss and gathered gradients), the step at world size 1
bit for bit against the unsharded step, and shard_inference_demo
against the unsharded forward."""

import jax
import numpy as np
import pytest
import torch

from nanocaller_tpu.models import SNPModel as JSNPModel
from nanocaller_tpu.runtime import sharding as JS
from nanocaller_tpu.train.snp_train import snp_loss as j_snp_loss
from nanocaller_tpu_torch.models import (SNPModel, load_model,
                                         params_from_torch_state_dict,
                                         torch_state_dict_from_params)
from nanocaller_tpu_torch.pileup.snp_dense import snp_dense_pileup
from nanocaller_tpu_torch.runtime import sharding as S
from nanocaller_tpu_torch.sim import random_dense_batch
from nanocaller_tpu_torch.train.snp_train import make_train_step, to_device

from torch_threads import _torch_threads  # noqa: F401 (autouse)

ATOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _flax(state):
    """A torch-layout {name: array} → a flax params tree."""
    return params_from_torch_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})


def _unsharded(state, batch):
    """The port's unsharded step (make_train_step): (loss, gradients,
    weights after the update), as {name: numpy array}."""
    m = SNPModel()
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    loss = make_train_step(m, torch.optim.Adam(m.parameters(), lr=1e-3))(
        to_device(batch, "cpu"))
    return (float(loss),
            {n: p.grad.numpy() for n, p in m.named_parameters()},
            {n: p.detach().numpy() for n, p in m.named_parameters()})


@pytest.mark.parametrize("world,dp", [(1, None), (2, None), (3, None),
                                      (4, None), (4, 2), (4, 4), (8, None),
                                      (8, 2), (6, 3)])
def test_make_mesh_matches_jax(world, dp):
    mesh = S.make_mesh(world, dp)
    jmesh = JS.make_mesh(world, dp)
    assert mesh.shape == dict(jmesh.shape)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(mesh.grid, ids)
    for r in range(mesh.world):
        assert tuple(np.argwhere(mesh.grid == r)[0]) == mesh.coords(r)


@pytest.mark.parametrize("world,dp", [(4, 2), (2, None), (8, None)])
def test_param_shardings_match_jax(world, dp):
    """Each rank's slice of every SNP weight equals the shard JAX places
    on the device of the same mesh position."""
    state = S.demo_state(seed=3)
    params = _flax(state)
    mesh = S.make_mesh(world, dp)
    jmesh = JS.make_mesh(world, dp)
    placed = jax.device_put(params, JS.snp_param_shardings(jmesh, params))
    axes = S.snp_param_shardings(mesh, state)
    assert {n for n, a in axes.items() if a is not None} == {
        "fc1.weight", "fc1.bias", "fa.weight", "fc2.weight"}
    for r in range(mesh.world):
        local = _flax({n: S.local_shard(mesh, r, v, axes[n])
                       for n, v in state.items()})
        for layer, vars_ in placed["params"].items():
            for var, arr in vars_.items():
                shard = next(s for s in arr.addressable_shards
                             if s.device.id == r)
                np.testing.assert_array_equal(
                    local["params"][layer][var], np.asarray(shard.data),
                    err_msg="rank %d %s/%s" % (r, layer, var))


def test_param_shardings_refuse_an_uneven_split():
    with pytest.raises(ValueError, match="split"):
        S.snp_param_shardings(S.Mesh(1, 5), S.demo_state())


def test_sharded_step_matches_jax_and_unsharded():
    """(dp=2, mdl=2) on four Gloo processes: the loss and the gathered
    gradients against the JAX step on make_mesh(4, dp=2) (XLA's own
    collectives) and against the port's unsharded step. A missed
    collective would show here: without (b) the conv trunk's gradients
    come out short, without (a) the loss and every gradient move."""
    mesh = S.make_mesh(4, dp=2)
    state = S.demo_state(seed=1)
    batch = S.demo_batch(mesh, seed=2)
    out = S.shard_train_step_demo(4, dp=2, device="cpu", state_dict=state,
                                  batch=batch)
    assert out["mesh"] == mesh

    jmesh = JS.make_mesh(4, dp=2)
    params = _flax(state)
    p_shard = JS.snp_param_shardings(jmesh, params)
    b_shard = jax.tree.map(lambda _: JS.batch_sharding(jmesh), batch)
    model = JSNPModel()
    vg = jax.jit(jax.value_and_grad(lambda p, b: j_snp_loss(model, p, b)),
                 in_shardings=(p_shard, b_shard))
    jloss, jgrads = vg(jax.device_put(params, p_shard),
                       jax.device_put(batch, b_shard))
    loss, grads, _ = _unsharded(state, batch)
    for want_loss, want_grads in ((float(jloss), jgrads),
                                  (loss, _flax(grads))):
        assert abs(out["loss"] - want_loss) <= ATOL
        got = _flax(out["grads"])
        for layer, vars_ in want_grads["params"].items():
            for var, w in vars_.items():
                np.testing.assert_allclose(
                    got["params"][layer][var], np.asarray(w),
                    rtol=GRAD_RTOL, atol=GRAD_ATOL,
                    err_msg="%s/%s" % (layer, var))
    for n, v in out["params"].items():
        assert v.shape == state[n].shape and not np.array_equal(v, state[n])


def test_sharded_step_world_one_is_the_unsharded_step():
    """One rank: the collectives are identities and the step computes the
    unsharded step's loss, gradients and updated weights bit for bit."""
    mesh = S.make_mesh(1)
    state, batch = S.demo_state(), S.demo_batch(mesh)
    out = S.shard_train_step_demo(1, device="cpu", state_dict=state,
                                  batch=batch)
    loss, grads, params = _unsharded(state, batch)
    assert out["loss"] == loss
    for n in state:
        np.testing.assert_array_equal(out["grads"][n], grads[n], err_msg=n)
        np.testing.assert_array_equal(out["params"][n], params[n],
                                      err_msg=n)


@pytest.mark.parametrize("dp,B", [(2, None), (3, 10)])
def test_shard_inference_demo_matches_unsharded(dp, B):
    """Rows split over dp replicas with replicated weights: the unsharded
    forward's probabilities (K5's twin and the CNN on the same
    per-device slices), bit for bit."""
    mesh = S.make_mesh(dp, dp)
    got = S.shard_inference_demo(mesh, device="cpu", B=B)
    B = B or max(8, 2 * dp)
    assert got.shape == (B, 4)
    arrays = random_dense_batch(np.random.default_rng(0), B, 32)
    m = SNPModel()
    m.load_state_dict(torch_state_dict_from_params(
        load_model("snp", "ONT-HG002")[0]))
    per = -(-B // dp)
    want = []
    with torch.inference_mode():
        for lo in range(0, B, per):
            x, ref = snp_dense_pileup(*(torch.from_numpy(
                np.ascontiguousarray(a[lo:lo + per])) for a in arrays))
            want.append(m(x, ref)[0][:, :, 1].numpy())
    np.testing.assert_array_equal(got, np.concatenate(want))
