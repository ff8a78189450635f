"""The streaming engine on the card: pinned host buffers, the copy stream,
the copy-back stream and the worker threads, which the CPU tests do not
reach. Marker ``cuda``; skips without a card; imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_streaming.py
"""

import json
import os

import numpy as np
import pytest
import torch

from delivr_cfos_tpu_torch.engine import streaming as st
from delivr_cfos_tpu_torch.engine.sliding_window import SlidingWindowConfig, infer_volume
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    build_model,
    init_state_dict,
)

pytestmark = pytest.mark.cuda

TINY = (4, 4, 8, 16, 32, 4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the streams and pinned buffers are CUDA's")
    return torch.device("cuda")


def _volume():
    rng = np.random.default_rng(0)
    vol = np.zeros((72, 32, 48), np.uint16)
    vol[:, :16] = (rng.random((72, 16, 48)) * 800 + 40000).astype(np.uint16)
    return vol


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_streaming_on_the_card(dev, tmp_path, precision):
    """Prefetch on and off give the same bits, the logits match the
    in-memory engine, and a resume from slab 2 gives the same bits."""
    mcfg = BasicUNetConfig(features=TINY, precision=precision)
    model = build_model(init_state_dict(mcfg, torch.Generator().manual_seed(3)), mcfg, dev)
    vol = _volume()
    cfg = SlidingWindowConfig(roi=(16, 16, 16), batch_size=4, tta=True,
                              tta_noise_std=0.2, erosion_iters=3)
    runs = []
    for prefetch in (True, False):
        log = np.empty(vol.shape, np.float32)
        bins, _ = st.infer_volume_streaming(model, vol, cfg, mcfg, slab_z_starts=2,
                                            logits_out=log, prefetch=prefetch)
        runs.append((bins, log))
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    np.testing.assert_array_equal(runs[0][0], runs[1][0])

    quiet = SlidingWindowConfig(roi=(16, 16, 16), batch_size=4, erosion_iters=3)
    want, _ = infer_volume(model, vol, quiet, mcfg, return_binary=False)
    log = np.empty(vol.shape, np.float32)
    st.infer_volume_streaming(model, vol, quiet, mcfg, slab_z_starts=2, logits_out=log)
    np.testing.assert_allclose(log, want.cpu().numpy(), rtol=1e-4, atol=1e-4)

    state = str(tmp_path / "resume.json")
    with open(state, "w") as f:
        json.dump({"sig": st.resume_signature(cfg, vol.shape, vol.shape, 2, batch=4),
                   "next_slab": 2, "finalized": 32}, f)
    bins, log = runs[0][0].copy(), runs[0][1].copy()
    bins[32:], log[32:] = 255, -1
    st.infer_volume_streaming(model, vol, cfg, mcfg, slab_z_starts=2, binary_out=bins,
                              logits_out=log, resume_state_path=state)
    assert not os.path.exists(state)
    np.testing.assert_array_equal(log, runs[0][1])
    np.testing.assert_array_equal(bins, runs[0][0])
