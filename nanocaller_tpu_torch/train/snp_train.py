"""SNP model training: loss + torch train step (the port of
nanocaller_tpu/train/snp_train.py).

Loss parity with the reference TF1 trainer
(misc/training/model_architect.py:130-146): mean softmax CE for each of
the four per-base heads + the GT head (weight 1.0) + 1e-3 × L2 on the
conv and dense weights (tf.nn.l2_loss = sum(x²)/2, weights only, biases
excluded).

One deliberate deviation, documented: the reference's training graph
concatenates per-base LOGITS into the GT branch
(misc/training/model_architect.py:54) while its inference model
concatenates softmax PROBABILITIES (nanocaller_src/model_architect.py:61)
— the two nets disagree. We train the inference wiring so train and
serve are the same function.

The update is torch.optim.Adam(lr=lr): its defaults (β 0.9 / 0.999,
ε 1e-8 outside the square root, no weight decay) compute what
optax.adam(lr) computes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import SNPModel
from ..models.weights import (init_params as _init_params,
                              params_from_torch_state_dict, params_to_npz,
                              torch_state_dict_from_params)
from ..runtime.device import resolve_device
from .data import batches_from_examples

L2_GAMMA = 1e-3


def softmax_ce(logits, labels):
    """optax.softmax_cross_entropy: -Σ labels · log_softmax(logits)."""
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(-1)


def kernel_l2(model):
    """½Σw² over the conv and dense weights, not the biases (the JAX
    loss's `kernel` path filter), summed in parameter order."""
    reg = 0.0
    for name, p in model.named_parameters():
        if name.endswith(".weight"):
            reg = reg + (p * p).sum() / 2
    return reg


def snp_cost(model, batch):
    """The loss without its L2 term: the GT head's and the four per-base
    heads' mean softmax CE."""
    head_logits, gt_logits = model(batch["x"], batch["ref"],
                                   return_logits=True)
    cost = softmax_ce(gt_logits, batch["gt_label"]).mean()
    for i in range(4):
        cost = cost + softmax_ce(head_logits[:, i],
                                 batch["base_labels"][:, i]).mean()
    return cost


def snp_loss(model, batch, l2_gamma=L2_GAMMA):
    """batch: dict of tensors on the model's device, x (B,5,41,5), ref
    (B,4), base_labels (B,4,2), gt_label (B,2)."""
    return snp_cost(model, batch) + l2_gamma * kernel_l2(model)


def make_train_step(model, opt, loss_fn=snp_loss):
    """step(batch) → the batch's loss (a 0-d tensor on the device, before
    the update): the gradient of loss_fn(model, batch) by autograd, then
    one opt.step()."""

    def train_step(batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step


def to_device(batch, device):
    """A numpy batch dict → float32 tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            .to(device) for k, v in batch.items()}


def new_model(cls, seed, init_params=None):
    """cls() with init_params (a flax-style params tree) loaded, or
    initialised as flax's defaults from a torch.Generator seeded with
    `seed` (models.weights.init_params)."""
    model = cls()
    if init_params is None:
        _init_params(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(torch_state_dict_from_params(init_params))
    return model


def train_snp_model(train_examples, val_examples, out_dir, *, epochs=100,
                    lr=1e-3, batch_size=128, seed=0, init_params=None,
                    log=print, device="cuda"):
    """Epoch loop mirroring the reference trainer's shape
    (model_run.py:93-186: per-epoch validation + checkpoint-per-epoch,
    retrain-from-checkpoint via init_params). Checkpoints are saved as
    npz packs directly loadable by both packages' models.load_model.
    "cuda" without a GPU raises. Returns (params, history): the final
    weights as a flax-style tree of numpy arrays and one dict an epoch
    (loss, val_acc, ckpt)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # the JAX trainer draws one batch order from rng for its init batch:
    # drawing it too keeps the epochs' batch order the same for a seed
    rng.permutation(len(train_examples["gt"]))
    model = new_model(SNPModel, seed, init_params).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    step = make_train_step(model, opt)

    os.makedirs(out_dir, exist_ok=True)
    history = []
    for epoch in range(epochs):
        losses = [step(to_device(b, dev)) for b in batches_from_examples(
            train_examples, batch_size, rng)]
        losses = [float(x) for x in losses]
        val_acc = None
        if val_examples is not None and len(val_examples["gt"]):
            n_ok = n_tot = 0
            for batch in batches_from_examples(
                    val_examples, min(batch_size, len(val_examples["gt"])),
                    np.random.default_rng(0)):
                n_ok += joint_accuracy(model, to_device(batch, dev))
                n_tot += len(batch["gt_label"])
            val_acc = n_ok / max(1, n_tot)
        ckpt = os.path.join(out_dir, "snp_model-%d.npz" % (epoch + 1))
        params_to_npz(ckpt, params_from_torch_state_dict(model.state_dict()))
        history.append({"epoch": epoch + 1,
                        "loss": float(np.mean(losses)) if losses else None,
                        "val_acc": val_acc, "ckpt": ckpt})
        log("epoch %d loss %.4f val_acc %s" % (
            epoch + 1, history[-1]["loss"] or 0.0, val_acc))
    return params_from_torch_state_dict(model.state_dict()), history


def joint_accuracy(model, batch):
    """The reference's 5-head joint accuracy metric
    (misc/training/model_architect.py:172-175): how many rows of the
    batch get the GT head and all four per-base heads right."""
    with torch.no_grad():
        head_logits, gt_logits = model(batch["x"], batch["ref"],
                                       return_logits=True)
        ok = gt_logits.argmax(-1) == batch["gt_label"].argmax(-1)
        for i in range(4):
            ok &= head_logits[:, i].argmax(-1) == \
                batch["base_labels"][:, i].argmax(-1)
    return int(ok.sum())
