"""Indel model training (the port of nanocaller_tpu/train/indel_train.py).

Loss parity with misc/training/model_architect_indel.py: 4-class softmax
CE over {hom-ref, hom-alt, het-ref, het-alt} + 1e-5 × L2 on the conv and
dense weights (the reference also computes a focal-loss variant it never
uses, :112-126 — omitted). Input (B,15,128,2) = hap0/hap1/all tensors
stacked on rows; the reader-side count→frequency-minus-ref normalization
(model_run_indels.py:229-232) is already how the inference tensors are
built, so features are shared between train and serve. The update is
torch.optim.Adam(lr=lr), as snp_train's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import IndelModel
from ..models.weights import params_from_torch_state_dict, params_to_npz
from ..runtime.device import resolve_device
from .snp_train import kernel_l2, make_train_step, new_model

L2_GAMMA = 1e-5
_P_MIN, _P_MAX = 1e-9, 1.0


def indel_loss(model, batch, l2_gamma=L2_GAMMA):
    """batch: x (B,15,128,2), label (B,4) one-hot genotype class, tensors
    on the model's device."""
    probs = model(batch["x"])
    # jnp.clip's minimum-of-maximum: half the gradient at a bound that a
    # probability equals (torch.clamp would pass all of it)
    clipped = torch.minimum(torch.maximum(probs, probs.new_tensor(_P_MIN)),
                            probs.new_tensor(_P_MAX))
    ce = -(batch["label"] * torch.log(clipped)).sum(-1).mean()
    return ce + l2_gamma * kernel_l2(model)


def make_indel_train_step(model, opt):
    return make_train_step(model, opt, loss_fn=indel_loss)


def label_candidates_from_truth(batch, truth_indels, window=10):
    """Assign 4-class labels to an IndelBatch from a truth indel map.

    truth_indels: {pos1: gt_class} with gt_class ∈ {1: hom-alt,
    2: het-ref, 3: het-alt}; candidates with no truth indel within
    ±window are hom-ref (0). Mirrors the candidate-class assignment idea
    of misc/training/generate_indel_pileups.py:179-183.
    """
    labels = np.zeros(len(batch), np.int64)
    tpos = np.array(sorted(truth_indels), dtype=np.int64)
    for j, p in enumerate(batch.pos):
        if len(tpos):
            i = np.searchsorted(tpos, p)
            for k in (i - 1, i):
                if 0 <= k < len(tpos) and abs(int(tpos[k]) - p) <= window:
                    labels[j] = truth_indels[int(tpos[k])]
                    break
    return labels


def train_indel_model(x, labels, out_dir, *, epochs=50, lr=1e-3,
                      batch_size=64, seed=0, init_params=None, log=print,
                      device="cuda"):
    """x: (N,15,128,2) float32; labels: (N,) int 0..3. A checkpoint an
    epoch (npz, loadable by both packages' load_model); "cuda" without a
    GPU raises. Returns (params, history) as train_snp_model does."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = new_model(IndelModel, seed, init_params).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    step = make_indel_train_step(model, opt)
    os.makedirs(out_dir, exist_ok=True)
    history = []
    onehot = np.eye(4, dtype=np.float32)
    for epoch in range(epochs):
        order = rng.permutation(len(labels))
        losses = []
        for lo in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[lo : lo + batch_size]
            losses.append(step({
                "x": torch.from_numpy(np.ascontiguousarray(
                    x[idx], np.float32)).to(dev),
                "label": torch.from_numpy(onehot[labels[idx]]).to(dev)}))
        losses = [float(v) for v in losses]
        ckpt = os.path.join(out_dir, "indel_model-%d.npz" % (epoch + 1))
        params_to_npz(ckpt, params_from_torch_state_dict(model.state_dict()))
        history.append({"epoch": epoch + 1,
                        "loss": float(np.mean(losses)) if losses else None,
                        "ckpt": ckpt})
        log("epoch %d loss %.4f" % (epoch + 1, history[-1]["loss"] or 0.0))
    return params_from_torch_state_dict(model.state_dict()), history
