"""SNP calling CNNs (diploid + haploid) as torch nn.Modules.

Same networks as nanocaller_tpu/models/snp.py (flax):
- diploid  SNPModel         input (B,5,41,5) pileup + (B,4) ref one-hot;
  four per-base 2-way heads A, G, T, C and a 2-way GT head
- haploid  HaploidSNPModel  same input; one 4-way softmax over A/G/T/C

The public layout stays NHWC as in the JAX package; the trunk permutes
to NCHW for torch's convolutions and back to NHWC before flattening, so
fc1 sees its 3·9·64 = 1,728 inputs in the flax order. Flax's SAME
padding for odd kernels is symmetric: conv1_1 (1,5), conv1_2 (5,1) and
conv1_3 (5,5) pad (0,2), (2,0) and (2,2). Load weights with
models.weights.torch_state_dict_from_params.

For inference on CUDA (grad mode off, as under the callers'
inference_mode) the convolutions up to fc1 run as one launch of kernel K6
(models/snp_trunk.py) on weights packed once a device
(_Trunk.trunk_weights); with grad mode on (training, the tensor-parallel
step) and on the CPU the nn.Conv2d trunk below runs, the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .snp_trunk import pack_trunk_weights, snp_trunk


class _Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1_1 = nn.Conv2d(5, 16, (1, 5), padding=(0, 2))
        self.conv1_2 = nn.Conv2d(5, 16, (5, 1), padding=(2, 0))
        self.conv1_3 = nn.Conv2d(5, 16, (5, 5), padding=(2, 2))
        self.conv2 = nn.Conv2d(48, 32, (2, 3), stride=(1, 2))
        self.conv3 = nn.Conv2d(32, 64, (2, 3), stride=(1, 2))
        self.fc1 = nn.Linear(3 * 9 * 64, 48)
        # K6's packed weights by device: (the weights' addresses and
        # versions when packed, the packed vector)
        self._k6 = {}

    def dense(self, layer, x):
        """One of the dense layers fc1, fa and fc2 applied to x (the
        tensor-parallel train step, runtime/sharding.py, applies its
        slices of them instead)."""
        return layer(x)

    def trunk_weights(self):
        """K6's packed weights on the module's device
        (snp_trunk.pack_trunk_weights). Packed at the first call on a
        device, and repacked into the same tensor, in place, whenever a
        weight has moved or changed since (a load_state_dict or an
        optimiser step bumps its version), so that a CUDA graph that
        captured K6 reads the current weights at the address it holds."""
        convs = [(c.weight, c.bias) for c in (
            self.conv1_1, self.conv1_2, self.conv1_3, self.conv2, self.conv3)]
        key = tuple((t.data_ptr(), t._version) for wb in convs for t in wb)
        dev = convs[0][0].device
        held = self._k6.get(dev)
        if held is None or held[0] != key:
            # a normal tensor, refreshed in place also under
            # inference_mode
            with torch.inference_mode(False), torch.no_grad():
                packed = pack_trunk_weights(convs)
                if held is not None:
                    packed = held[1].copy_(packed)
            self._k6[dev] = (key, packed)
        return self._k6[dev][1]

    def conv_trunk(self, x):
        """The nn.Conv2d trunk: x (B,5,41,5) → fc1's (B, 1,728) input."""
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        m = torch.cat([F.selu(self.conv1_1(x)), F.selu(self.conv1_2(x)),
                       F.selu(self.conv1_3(x))], dim=1)
        m = F.selu(self.conv2(m))
        m = F.selu(self.conv3(m))
        return m.permute(0, 2, 3, 1).reshape(m.shape[0], -1)  # NHWC order

    def trunk(self, x):
        if x.is_cuda and not torch.is_grad_enabled():
            flat = snp_trunk(x.contiguous(), self.trunk_weights())
        else:
            flat = self.conv_trunk(x)
        return F.selu(self.dense(self.fc1, flat))


class SNPModel(_Trunk):
    """Diploid SNP model: conv trunk + 4 per-base heads + GT head."""

    def __init__(self):
        super().__init__()
        self.fa = nn.Linear(48, 16)
        self.A = nn.Linear(17, 2)
        self.G = nn.Linear(17, 2)
        self.T = nn.Linear(17, 2)
        self.C = nn.Linear(17, 2)
        self.fc2 = nn.Linear(48, 16)
        self.fc3 = nn.Linear(16 + 4 * 2, 8)
        self.GT = nn.Linear(8, 2)

    def forward(self, x, ref, return_logits=False):
        """x: (B,5,41,5) float32; ref: (B,4) one-hot of the candidate's
        ref base → (probs (B,4,2) of the A,G,T,C heads, gt (B,2)); with
        return_logits=True the pre-softmax head logits (B,4,2) and GT
        logits (B,2) instead (the training loss, train/snp_train.py).
        The GT branch takes the heads' softmax outputs either way, as
        the JAX model does."""
        fc1 = self.trunk(x)
        fa = F.selu(self.dense(self.fa, fc1))
        logits = [head(torch.cat([fa, ref[:, i:i + 1]], dim=1))
                  for i, head in enumerate((self.A, self.G, self.T, self.C))]
        outs = [torch.softmax(lg, dim=-1) for lg in logits]
        fc2 = F.selu(self.dense(self.fc2, fc1))
        fc3 = F.selu(self.fc3(torch.cat([fc2] + outs, dim=1)))
        gt_logits = self.GT(fc3)
        if return_logits:
            return torch.stack(logits, dim=1), gt_logits
        return torch.stack(outs, dim=1), torch.softmax(gt_logits, dim=-1)


class HaploidSNPModel(_Trunk):
    """Haploid SNP model: same trunk, one 4-way softmax over A/G/T/C."""

    def __init__(self):
        super().__init__()
        self.fc2 = nn.Linear(48, 16)
        self.fc3 = nn.Linear(16 + 4, 4)

    def forward(self, x, ref):
        """x: (B,5,41,5) float32; ref: (B,4) → (B,4) base probabilities."""
        fc2 = F.selu(self.fc2(self.trunk(x)))
        # selu THEN softmax, as the flax model and the reference do
        # (nanocaller_tpu/models/snp.py:69-72)
        return torch.softmax(F.selu(self.fc3(torch.cat([fc2, ref], dim=1))),
                             dim=-1)
