"""Stage 1's device ops on the card against the same ops on the CPU.

Stage 1 runs no hand-written kernel: its downsample, feature bank, forest
and mask zoom are plain torch. The feature bank sums shifted slices (one
multiply and one add per tap, each rounded to float32; square roots
rounded once from float64, since CUDA's float32 square root differs from
the CPU's in the last bit) and runs no library convolution, so the card
must give the CPU's bits; the forest's gathers and comparisons then give
the same probabilities, and stage 1 the same files. The eigenvalue features
use arccos and cos, whose CUDA and CPU versions round differently, and
arccos near ±1 (nearly equal eigenvalues) magnifies that: within 1e-3 of
the largest magnitude (1.6e-4 seen on an H100). These tests carry
the ``cuda`` marker, skip where there is no card, and import neither JAX nor
the JAX package (run without tests/conftest.py on a GPU machine):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_stage01.py
"""

import os

import numpy as np
import pytest
import torch

from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.models.pixel_classifier import (
    _forest_eval,
    fit_pixel_classifier,
    predict_probabilities,
    save_model,
)
from delivr_cfos_tpu_torch.ops.features import _sqrt_f32, feature_bank, ilastik_feature_bank
from delivr_cfos_tpu_torch.ops.resample import (
    block_mean_downsample,
    contrast_stretch_8bit,
    zoom_mask_to,
)
from delivr_cfos_tpu_torch.pipeline.stage01_downsample_mask import downsample_mask
from delivr_cfos_tpu_torch.utils.device import upload
from delivr_cfos_tpu_torch.utils.io.tiff import write_tiff

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _stack(shape, seed):
    rng = np.random.default_rng(seed)
    z, y, x = shape
    st = (rng.random(shape) * 40).astype(np.float32)
    zz, yy, xx = np.ogrid[:z, :y, :x]
    ell = (((zz - z / 2) / (z / 2.2)) ** 2 + ((yy - y / 2) / (y / 2.5)) ** 2
           + ((xx - x / 2) / (x / 2.5)) ** 2) < 1
    st[ell] += 120 + rng.random(int(ell.sum())) * 60
    return st.clip(0, 255).astype(np.uint8), ell


def test_block_mean_on_the_card_equals_the_cpu(dev):
    vol = (65535 - np.random.default_rng(0).random((16, 151, 97)) * 60000).astype(np.uint16)
    for factors in ((4, 15, 15), (2, 4, 4)):
        got = block_mean_downsample(upload(vol, dev), factors).cpu().numpy()
        want = block_mean_downsample(upload(vol, "cpu"), factors).numpy()
        np.testing.assert_array_equal(got, want)


def test_sqrt_f32_on_the_card_equals_the_cpu(dev):
    """The feature bank's square root: float64, rounded once to float32."""
    x = torch.rand(1 << 22, generator=torch.Generator().manual_seed(9)) * 1000
    np.testing.assert_array_equal(_sqrt_f32(x.to(dev)).cpu().numpy(), _sqrt_f32(x).numpy())


def test_feature_banks_on_the_card_equal_the_cpu(dev):
    st, _ = _stack((40, 64, 56), 1)
    got = feature_bank(upload(st, dev)).cpu().numpy()
    np.testing.assert_array_equal(got, feature_bank(upload(st, "cpu")).numpy())
    spec = (("GaussianSmoothing", 1.0), ("LaplacianOfGaussian", 3.5),
            ("GaussianGradientMagnitude", 1.6), ("DifferenceOfGaussians", 0.7))
    got = ilastik_feature_bank(upload(st, dev), spec).cpu().numpy()
    np.testing.assert_array_equal(got, ilastik_feature_bank(upload(st, "cpu"), spec).numpy())
    spec = (("StructureTensorEigenvalues", 1.0), ("HessianOfGaussianEigenvalues", 1.6))
    got = ilastik_feature_bank(upload(st, dev), spec).cpu().numpy()
    want = ilastik_feature_bank(upload(st, "cpu"), spec).numpy()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_forest_on_the_card_equals_the_cpu(dev):
    st, ell = _stack((24, 48, 40), 2)
    lab = np.where(np.random.default_rng(3).random(st.shape) < 0.05,
                   np.where(ell, 1, 2), 0).astype(np.uint8)
    model = fit_pixel_classifier([st], [lab], max_samples=20000, device=dev)
    feats = feature_bank(upload(st, "cpu")).reshape(-1, 12)
    args = [torch.from_numpy(model["feature"]).long(), torch.from_numpy(model["threshold"]),
            torch.from_numpy(model["leaf"])]
    want = _forest_eval(feats, *args, max_depth=int(model["max_depth"])).numpy()
    got = _forest_eval(feats.to(dev), *(a.to(dev) for a in args),
                       max_depth=int(model["max_depth"])).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    st2, _ = _stack((40, 48, 40), 4)
    np.testing.assert_array_equal(predict_probabilities(st2, model, device=dev),
                                  predict_probabilities(st2, model, device="cpu"))


def test_zoom_and_stretch_on_the_card_equal_the_cpu(dev):
    mask = (np.random.default_rng(5).random((47, 32, 26)) > 0.3).astype(np.uint8)
    got = zoom_mask_to(mask, (192, 480, 384), chunk_z=50, device=dev)
    np.testing.assert_array_equal(got, zoom_mask_to(mask, (192, 480, 384), device="cpu"))
    flat = np.random.default_rng(6).integers(0, 4000, 2**24 + 77, dtype=np.uint16)
    np.testing.assert_array_equal(contrast_stretch_8bit(upload(flat, dev)).cpu().numpy(),
                                  contrast_stretch_8bit(upload(flat, "cpu")).numpy())


def test_downsample_mask_forest_branch_on_the_card_equals_the_cpu(tmp_path, dev):
    """Stage 1 with a fitted forest on tests/test_stage01_ingest.py's brain
    size: every file byte-equal between the card and the CPU."""
    rng = np.random.default_rng(7)
    vol = (rng.random((10, 64, 48)) * 400).astype(np.uint16)
    vol[:4, :40, :30] += 20000
    st, ell = _stack((8, 16, 12), 8)
    lab = np.where(rng.random(st.shape) < 0.2, np.where(ell, 1, 2), 0).astype(np.uint8)
    model = str(tmp_path / "forest.npz")
    # two scales keep the CPU run of the 256³ padded stack short; chip_smoke.py
    # runs the default three at stage level
    save_model(model, fit_pixel_classifier([st], [lab], sigmas=(0.7, 1.6), n_trees=4,
                                           max_depth=5, max_samples=2000, device=dev))
    files = {}
    for tag, device in (("cuda", dev), ("cpu", "cpu")):
        root = tmp_path / tag
        os.makedirs(root / "raw" / "b")
        for z in range(vol.shape[0]):
            write_tiff(str(root / "raw" / "b" / f"Z{z:04d}.tif"), vol[z])
        cfg = PipelineConfig.from_dict({
            "raw_location": str(root / "raw"),
            "mask_detection": {
                "output_location": str(root / "out") + os.sep, "ilastik_model": model,
                "downsample_steps": {"original_um_x": 6.25, "original_um_y": 6.25,
                                     "original_um_z": 12.5},
                "mask_with_Ilastik": True,
            },
            "blob_detection": {"window_dimensions": {f"window_dim_{i}": 16 for i in range(3)}},
            "FLAGS": {"ABSPATHS": True},
        })
        seconds = downsample_mask(cfg, "b", device=device)
        assert {"features", "forest", "zoom"} <= set(seconds)
        files[tag] = {}
        for d, _, names in os.walk(root / "out"):
            for n in names:
                with open(os.path.join(d, n), "rb") as f:
                    files[tag][os.path.relpath(os.path.join(d, n), root / "out")] = f.read()
    assert sorted(files["cuda"]) == sorted(files["cpu"])
    for name in files["cpu"]:
        assert files["cuda"][name] == files["cpu"][name], name
