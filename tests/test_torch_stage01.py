"""The port's stage 1 (pipeline/stage01_downsample_mask.py) against the JAX
package's on tests/test_stage01_ingest.py's raw brain, and stage 1 → stage 2
against the JAX package's chain.

Every output file must be byte-equal to the JAX package's (TIFFs, v3draw,
``mask_us.npy``, ``masked_nifti.npy``) in the Otsu branch
(``mask_with_Ilastik`` with no model file) and in the simple-threshold
branch: the downsample sums stay below 2^24 (values up to 60000 in blocks of
16), and the mask zoom agrees on every voxel (tests/test_torch_resample.py).
The forest branch predicts on the 256³ padded stack, which takes tens of
seconds on one CPU thread; it is held at the module level here
(tests/test_torch_pixel_classifier.py) and at the stage level on the card
(tests/test_torch_cuda_stage01.py and chip_smoke.py's ``stage1`` phase).
The chain's stage 2 is held as tests/test_torch_stage02.py holds it:
sigmoid within 1e-4, binaries equal outside the ±1e-3 logit band.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from delivr_cfos_tpu.config import PipelineConfig as JaxPipelineConfig
from delivr_cfos_tpu.models.convert import save_params_npz, torch_state_dict_to_params
from delivr_cfos_tpu.pipeline.stage01_downsample_mask import downsample_mask as jax_stage1
from delivr_cfos_tpu.pipeline.stage02_inference import run_inference as jax_stage2
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig, init_state_dict
from delivr_cfos_tpu_torch.native.build import native_available
from delivr_cfos_tpu_torch.pipeline.stage01_downsample_mask import downsample_mask
from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference
from delivr_cfos_tpu_torch.utils.io.tiff import write_tiff
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_SHAPE = (10, 64, 48)  # tests/test_stage01_ingest.py's brain
TINY = (4, 4, 8, 16, 32, 4)
BAND = 1e-3


def _raw_volume(seed=2):
    rng = np.random.default_rng(seed)
    vol = (rng.random(RAW_SHAPE) * 400).astype(np.uint16)
    vol[3:5, 10:20, 10:20] = 60000
    return vol


def _write_raw(raw_dir, vol, writer=None):
    os.makedirs(raw_dir, exist_ok=True)
    for z in range(vol.shape[0]):
        path = os.path.join(raw_dir, f"Z{z:04d}.tif")
        (writer or write_tiff)(path, vol[z])


def _raw(root, *, ilastik, threads=1, model=""):
    """tests/test_stage01_ingest.py's config: ratios (2, 4, 4), window 16."""
    return {
        "raw_location": os.path.join(root, "raw"),
        "output_location": os.path.join(root, "out"),
        "mask_detection": {
            "output_location": os.path.join(root, "out", "01") + os.sep,
            "ilastik_model": model,
            "downsample_steps": {
                "original_um_x": 6.25, "original_um_y": 6.25, "original_um_z": 12.5,
                "downsample_um_x": 25.0, "downsample_um_y": 25.0,
                "downsample_um_z": 25.0,
            },
            "mask_with_Ilastik": ilastik,
            "simple_threshold_value": 250,
            "ingest_threads": threads,
        },
        "blob_detection": {
            "window_dimensions": {f"window_dim_{i}": 16 for i in range(3)},
        },
        "FLAGS": {"ABSPATHS": True},
    }


def _all_files(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _assert_same_files(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        assert ours[name] == theirs[name], f"{name} differs"


@pytest.mark.parametrize("ilastik,corner", [(True, False), (False, False), (True, True)],
                         ids=["otsu", "threshold", "otsu_corner"])
def test_downsample_mask_matches_jax(tmp_path, ilastik, corner):
    """tests/test_stage01_ingest.py's brain in both branches, and in the
    Otsu branch once more with a bright block at the stack's origin: the
    mask is predicted on the 256-padded stack and zoomed whole to the raw
    shape (a reference quirk), so only that corner of the padded mask
    reaches the raw grid."""
    vol = _raw_volume()
    if corner:
        vol[:2, :48, :40] = 30000
    files = {}
    for tag, cfg_cls, run in (("jax", JaxPipelineConfig, jax_stage1),
                              ("port", PipelineConfig, downsample_mask)):
        root = str(tmp_path / tag)
        _write_raw(os.path.join(root, "raw", "brainA"), vol)
        cfg = cfg_cls.from_dict(_raw(root, ilastik=ilastik))
        if tag == "port":
            seconds = run(cfg, "brainA", device="cpu")
        else:
            run(cfg, "brainA")
        files[tag] = _all_files(os.path.join(root, "out"))
    _assert_same_files(files["port"], files["jax"])
    names = set(files["port"])
    assert os.path.join("01", "brainA", "masked_niftis", "masked_nifti.npy") in names
    assert (os.path.join("01", "brainA", "mask_us.npy") in names) == ilastik
    assert set(seconds) == ({"decode", "downsample", "zoom", "masking"} if ilastik
                            else {"decode", "downsample", "masking"})
    nii = np.load(tmp_path / "port" / "out" / "01" / "brainA" / "masked_niftis"
                  / "masked_nifti.npy")
    assert nii.shape == (1, 1, 16, 64, 48) and nii.dtype == np.uint16
    assert not nii[0, 0, 10:].any()  # the window padding
    if not ilastik:
        np.testing.assert_array_equal(nii[0, 0, :10], np.where(vol < 250, 0, vol))
    if corner:
        mask_us = np.load(tmp_path / "port" / "out" / "01" / "brainA" / "mask_us.npy")
        assert mask_us.any()
        np.testing.assert_array_equal(nii[0, 0, :10], vol * mask_us)


def test_ingest_threads_bit_identical(tmp_path):
    """Threaded decode-ahead and masking writes only move where the work
    happens: every output byte equals the serial run's."""
    vol = _raw_volume()
    files = {}
    for threads in (1, 4):
        root = str(tmp_path / f"t{threads}")
        _write_raw(os.path.join(root, "raw", "brainA"), vol)
        downsample_mask(PipelineConfig.from_dict(_raw(root, ilastik=True, threads=threads)),
                        "brainA", device="cpu")
        files[threads] = _all_files(os.path.join(root, "out"))
    _assert_same_files(files[4], files[1])


def test_config_parses_mask_detection_like_the_jax_package(tmp_path):
    raw = _raw(str(tmp_path), ilastik=True)
    raw["mask_detection"]["downsample_steps"]["original_um_z"] = 6.0
    for absolute in (True, False):
        raw["FLAGS"]["ABSPATHS"] = absolute
        ours = PipelineConfig.from_dict(raw).mask_detection
        theirs = JaxPipelineConfig.from_dict(raw).mask_detection
        assert ours == type(ours)(**{k: getattr(theirs, k) for k in vars(ours)
                                     if k != "downsample_steps"},
                                  downsample_steps=ours.downsample_steps)
        assert ours.downsample_steps.ratios_zyx == theirs.downsample_steps.ratios_zyx == (4, 4, 4)


def test_stage1_then_stage2_matches_the_jax_chain(tmp_path):
    """Stage 2 (parity, TINY features) reads stage 1's masked_nifti.npy in
    both packages; the port's chain against the JAX package's chain."""
    vol = _raw_volume()
    vol[:, :, 24:] //= 2  # structure for the UNet beyond the bright box
    sd = init_state_dict(BasicUNetConfig(features=TINY), torch.Generator().manual_seed(1))
    weights = str(tmp_path / "w.npz")
    save_params_npz(weights, torch_state_dict_to_params(sd))
    outs = {}
    for tag, cfg_cls, s1, s2 in (("jax", JaxPipelineConfig, jax_stage1, jax_stage2),
                                 ("port", PipelineConfig, downsample_mask, run_inference)):
        root = str(tmp_path / tag)
        _write_raw(os.path.join(root, "raw", "brainA"), vol)
        raw = _raw(root, ilastik=False)
        raw["blob_detection"].update({
            "input_location": raw["mask_detection"]["output_location"],
            "output_location": os.path.join(root, "out", "02") + os.sep,
            "model_location": weights,
            "erosion_iters": 2,
        })
        raw["FLAGS"].update({"TEST_TIME_AUGMENTATION": False, "SAVE_ACTIVATED_OUTPUT": True})
        cfg = cfg_cls.from_dict(raw)
        kw = {"device": "cpu"} if tag == "port" else {}
        s1(cfg, "brainA", **kw)
        session = s2(cfg, "brainA", (1, 1, *RAW_SHAPE), **kw)
        d = os.path.join(session, "binary_segmentations")
        outs[tag] = (np.load(os.path.join(d, "binaries.npy")),
                     np.load(os.path.join(d, "network_output.npy")))
    (p_bin, p_sig), (j_bin, j_sig) = outs["port"], outs["jax"]
    assert p_bin.shape == j_bin.shape == RAW_SHAPE
    np.testing.assert_allclose(p_sig, j_sig, atol=1e-4)
    logit = np.log(np.clip(j_sig, 1e-12, None)) - np.log(np.clip(1 - j_sig, 1e-12, None))
    outside = np.abs(logit) > BAND
    print(f"voxels inside the ±{BAND} logit band: {int((~outside).sum())}")
    assert int(j_bin.sum()) > 0
    np.testing.assert_array_equal(p_bin[outside], j_bin[outside])


def test_cuda_requested_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    root = str(tmp_path)
    _write_raw(os.path.join(root, "raw", "brainA"), _raw_volume())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        downsample_mask(PipelineConfig.from_dict(_raw(root, ilastik=False)), "brainA")
    assert not os.path.exists(os.path.join(root, "out"))


def test_without_the_tiff_codec_source_stage1_reads_with_python(tmp_path):
    """An installed copy without native/tiff_codec.cpp: the TIFF codec's
    library is None (its source hash raises inside the ``try``), the
    labeler's still builds, and stage 1 over LZW-compressed raw planes
    writes the same files through the Python decoders."""
    cv2 = pytest.importorskip("cv2")
    vol = _raw_volume()

    def lzw(path, img):
        assert cv2.imwrite(path, img, [cv2.IMWRITE_TIFF_COMPRESSION, 5])

    native_root = str(tmp_path / "native")
    _write_raw(os.path.join(native_root, "raw", "brainA"), vol, lzw)
    downsample_mask(PipelineConfig.from_dict(_raw(native_root, ilastik=False)),
                    "brainA", device="cpu")
    pkg = tmp_path / "site" / "delivr_cfos_tpu_torch"
    shutil.copytree(os.path.join(ROOT, "delivr_cfos_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tiff_codec.cpp"))
    assert not (pkg / "native" / "tiff_codec.cpp").exists()
    root = str(tmp_path / "python")
    _write_raw(os.path.join(root, "raw", "brainA"), vol, lzw)
    code = (
        "import delivr_cfos_tpu_torch as port\n"
        "from delivr_cfos_tpu_torch.config import PipelineConfig\n"
        "from delivr_cfos_tpu_torch.native.build import get_library\n"
        "from delivr_cfos_tpu_torch.native.tiff import decode_native\n"
        "from delivr_cfos_tpu_torch.pipeline.stage01_downsample_mask import downsample_mask\n"
        f"assert port.__file__.startswith({str(tmp_path)!r}), port.__file__\n"
        "assert get_library('tiff_codec') is None\n"
        "assert decode_native('lzw', b'\\x80', 16) is None\n"
        f"assert (get_library('cc_label') is not None) == {native_available('cc_label')}\n"
        f"downsample_mask(PipelineConfig.from_dict({_raw(root, ilastik=False)!r}), "
        "'brainA', device='cpu')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "site"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    _assert_same_files(_all_files(os.path.join(root, "out")),
                       _all_files(os.path.join(native_root, "out")))
