"""Load BasicUNet weights into the port's MONAI-keyed state dict.

Two formats, as in the JAX package (``delivr_cfos_tpu/models/convert.py``):

- the reference's MONAI torch checkpoint (``.tar``): a state dict under
  ``state_dict`` (reference: inference/inference.py:222) or ``model_state``
  (inference/inference_nifti_load.py:215), or bare; a DataParallel
  ``module.`` prefix is stripped;
- the JAX package's ``.npz`` (``save_params_npz``): a flat archive of the
  param pytree with '/'-joined keys, conv kernels DHWIO, deconv kernels in
  torch (I, O, 2, 2, 2) layout.
"""

from __future__ import annotations

import numpy as np
import torch

_TWO_CONVS = ("conv_0", "down_1", "down_2", "down_3", "down_4",
              "upcat_4", "upcat_3", "upcat_2", "upcat_1")


def _monai_prefix(block: str) -> str:
    return block if block == "conv_0" else f"{block}.convs"


def state_dict_from_jax_params(params) -> dict:
    """JAX param pytree (nested dicts of numpy arrays) → MONAI-keyed state
    dict of f32 tensors. Conv kernels go DHWIO → OIDHW; deconv kernels are
    already in torch layout."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def oidhw(a):
        return t(np.transpose(np.asarray(a), (4, 3, 0, 1, 2)))

    sd = {}
    for block in _TWO_CONVS:
        p = params[block]
        for i in (0, 1):
            c = p[f"conv_{i}"]
            pre = f"{_monai_prefix(block)}.conv_{i}"
            sd[f"{pre}.conv.weight"] = oidhw(c["w"])
            sd[f"{pre}.conv.bias"] = t(c["b"])
            sd[f"{pre}.adn.N.weight"] = t(c["scale"])
            sd[f"{pre}.adn.N.bias"] = t(c["bias"])
        if block.startswith("upcat"):
            sd[f"{block}.upsample.deconv.weight"] = t(p["deconv_w"])
            sd[f"{block}.upsample.deconv.bias"] = t(p["deconv_b"])
    sd["final_conv.weight"] = oidhw(params["final"]["w"])
    sd["final_conv.bias"] = t(params["final"]["b"])
    return sd


def load_params_npz(path: str) -> dict:
    """A ``.npz`` written by the JAX package's ``save_params_npz`` → the
    nested param tree of numpy arrays."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(z[key])
    return params


def load_torch_checkpoint(path: str) -> dict:
    """The reference's checkpoint → MONAI-keyed state dict, prefix stripped.
    Loaded with ``weights_only=True``: tensors and plain containers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict):
        for key in ("state_dict", "model_state"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    return {
        (k[len("module."):] if k.startswith("module.") else k): v.float()
        for k, v in ckpt.items()
    }


def load_weights(path: str) -> dict:
    """Weights from a JAX ``.npz`` or a MONAI ``.tar`` (by extension)."""
    if path.endswith(".npz"):
        return state_dict_from_jax_params(load_params_npz(path))
    return load_torch_checkpoint(path)
