"""The device labeler on the card against the host engine.

``label_volume_device`` is plain torch, but its int32 minima and int64
gathers run as CUDA kernels there, so the card gets its own case. It carries
the ``cuda`` marker, skips where there is no card, and imports neither JAX
nor the JAX package (run without tests/conftest.py on a GPU machine):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_connected_components.py
"""

import numpy as np
import pytest
import torch

from delivr_cfos_tpu_torch.ops.connected_components import (
    label_volume_device,
    label_volume_host,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,threshold", [
    ((24, 24, 24), 0.6),  # dense noise: many touching components
    ((30, 64, 48), 0.9),  # sparse noise: many small ones
    ((5, 300, 7), 0.3),  # one long component across the volume
    ((8, 8, 8), 1.0),  # nothing
])
def test_label_volume_device_on_the_card_matches_the_host(dev, shape, threshold):
    vol = (np.random.default_rng(sum(shape)).random(shape) > threshold).astype(np.uint8)
    labels, n, rounds = label_volume_device(vol, dev, return_rounds=True)
    want, n_want = label_volume_host(vol)
    assert n == n_want
    np.testing.assert_array_equal(labels, want)
    assert rounds >= 1
    # a tensor already on the card gives the same labels
    again, n_again = label_volume_device(torch.from_numpy(vol).to(dev), dev)
    assert n_again == n
    np.testing.assert_array_equal(again, labels)
