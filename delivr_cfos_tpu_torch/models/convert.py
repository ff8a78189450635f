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


def jax_params_from_state_dict(state_dict) -> dict:
    """MONAI-keyed state dict (tensors or arrays; a DataParallel ``module.``
    prefix is stripped) → the JAX package's param tree of float32 numpy
    arrays, the inverse of ``state_dict_from_jax_params``: conv kernels go
    OIDHW → DHWIO, deconv kernels stay in torch layout. The port's own
    version of the JAX package's ``torch_state_dict_to_params``."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in state_dict.items()}

    def a(key):
        v = sd[key]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.array(v, dtype=np.float32)

    def dhwio(key):
        return np.ascontiguousarray(np.transpose(a(key), (2, 3, 4, 1, 0)))

    params = {}
    for block in _TWO_CONVS:
        p = {}
        for i in (0, 1):
            pre = f"{_monai_prefix(block)}.conv_{i}"
            p[f"conv_{i}"] = {
                "w": dhwio(f"{pre}.conv.weight"),
                "b": a(f"{pre}.conv.bias"),
                "scale": a(f"{pre}.adn.N.weight"),
                "bias": a(f"{pre}.adn.N.bias"),
            }
        if block.startswith("upcat"):
            p["deconv_w"] = a(f"{block}.upsample.deconv.weight")
            p["deconv_b"] = a(f"{block}.upsample.deconv.bias")
        params[block] = p
    params["final"] = {"w": dhwio("final_conv.weight"), "b": a("final_conv.bias")}
    return params


def save_params_npz(path: str, params: dict) -> None:
    """Save a param tree as the JAX package's ``.npz`` (flat, '/'-joined
    keys, compressed), which its ``load_params_npz`` and the port's
    ``load_weights`` read."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}/", v)
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk("", params)
    np.savez_compressed(path, **flat)


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
