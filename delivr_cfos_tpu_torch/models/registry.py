"""Stage 2's segmentation models, chosen by the keys of their state dicts.

A state dict with keys under ``swinViT.`` is MONAI's SwinUNETR
(``models/swin_unetr.py``); one with BasicUNet's first conv,
``conv_0.conv_0.conv.weight``, is MONAI's BasicUNet
(``models/basic_unet.py``). The config that ``infer_model_config`` returns
carries what the engine needs of its model, whatever the architecture:
``build``, ``apply``, ``window_bytes`` (the batch and slab sizing) and
``shardable``.
"""

from __future__ import annotations

from delivr_cfos_tpu_torch.models import basic_unet, swin_unetr
from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig
from delivr_cfos_tpu_torch.models.swin_unetr import SwinUNETRConfig

BASIC_UNET_KEY = "conv_0.conv_0.conv.weight"


def _bare(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


def infer_model_config(state_dict) -> BasicUNetConfig | SwinUNETRConfig:
    """The architecture and its config from a MONAI-keyed state dict (a
    DataParallel ``module.`` prefix is ignored)."""
    keys = {_bare(k) for k in state_dict}
    if any(k.startswith(swin_unetr.KEY_PREFIX) for k in keys):
        return swin_unetr.infer_model_config(state_dict)
    if BASIC_UNET_KEY in keys:
        return basic_unet.infer_model_config(state_dict)
    raise ValueError(
        f"unknown model: the state dict has no key under {swin_unetr.KEY_PREFIX!r} "
        f"(SwinUNETR) and no {BASIC_UNET_KEY!r} (BasicUNet); its first keys are "
        f"{sorted(keys)[:5]}"
    )


def build_model(state_dict, config, device):
    """The model of ``config``'s architecture, in eval mode on ``device``."""
    return config.build(state_dict, device)
