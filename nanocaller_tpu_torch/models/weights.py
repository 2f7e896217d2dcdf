"""Weight storage and import.

Runtime weights live as flat .npz archives ("layer/kernel" → array) that
map 1:1 onto the flax param trees of nanocaller_tpu/models. The port
reads the same packs and carries them across to PyTorch's layouts with
`torch_state_dict_from_params`, and carries weights it trained back with
`params_from_torch_state_dict` and `params_to_npz`, so that both
packages' `load_model` read a pack the port wrote.
"""

from __future__ import annotations

import math

import numpy as np

# flax's lecun_normal draws from a normal truncated to ±2 standard
# deviations and divides the scale by that distribution's standard
# deviation, so the kernel's variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def params_from_npz(path):
    """Load a flat npz into a flax-style params dict {'params': {layer: {k: v}}}."""
    flat = np.load(path)
    tree = {}
    for key in flat.files:
        layer, var = key.rsplit("/", 1)
        tree.setdefault(layer, {})[var] = np.asarray(flat[key], dtype=np.float32)
    return {"params": tree}


def torch_state_dict_from_params(params):
    """flax tree of numpy arrays → `state_dict` of the port's nn.Modules.

    Conv kernels go from flax's HWIO to torch's OIHW; dense kernels from
    (in, out) to torch's (out, in). Biases are unchanged."""
    import torch

    out = {}
    for layer, vars_ in params["params"].items():
        for var, val in vars_.items():
            arr = np.asarray(val, dtype=np.float32)
            if var == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
                var = "weight"
            out["%s.%s" % (layer, var)] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return out


def params_from_torch_state_dict(state_dict):
    """`state_dict` of the port's nn.Modules (tensors or arrays) → flax
    tree of float32 numpy arrays, the inverse of
    torch_state_dict_from_params: conv kernels OIHW → HWIO, dense kernels
    (out, in) → (in, out), `.weight` → `kernel`; biases unchanged."""
    tree = {}
    for key, val in state_dict.items():
        layer, var = key.rsplit(".", 1)
        arr = val.detach().cpu().numpy() if hasattr(val, "detach") \
            else np.asarray(val)
        arr = arr.astype(np.float32)
        if var == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            var = "kernel"
        tree.setdefault(layer, {})[var] = np.ascontiguousarray(arr)
    return {"params": tree}


def params_to_npz(path, params):
    """Write a flax-style params tree as the flat "layer/kernel" npz that
    both packages' load_model read."""
    flat = {}
    for layer, vars_ in params["params"].items():
        for var, val in vars_.items():
            flat["%s/%s" % (layer, var)] = np.asarray(val)
    np.savez_compressed(path, **flat)
    return path


def init_params(model, generator):
    """Initialise `model` in place as flax's defaults do: every conv and
    dense weight from lecun_normal (a normal truncated at ±2 standard
    deviations, variance 1 / fan_in, fan_in = in_channels × kernel size
    for a conv), every bias zero. The draws come from `generator` (a CPU
    torch.Generator), in parameter order, so a seed gives the same
    weights on every device. Not bit-equal to a flax init; the same
    distributions (torch's own default init is not). Returns model."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
                continue
            fan_in = p[0].numel()  # (out, in, kh, kw) or (out, in)
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(p.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
            p.copy_(w)
    return model
