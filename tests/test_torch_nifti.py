"""The port's NIfTI-1 codec (``delivr_cfos_tpu_torch/utils/io/nifti.py``)
against the JAX package's (``delivr_cfos_tpu/utils/io/nifti.py``): files
written by either are read by the other; uncompressed files are byte-equal,
``.nii.gz`` files equal after decompression (gzip stamps the time)."""

import gzip

import numpy as np
import pytest

from delivr_cfos_tpu.utils.io import nifti as jnifti
from delivr_cfos_tpu_torch.utils import io as pio
from delivr_cfos_tpu_torch.utils.io import nifti as pnifti

DTYPES = [np.uint8, np.int16, np.uint16, np.int32, np.float32, np.float64]


def _volume(dtype, shape=(7, 5, 3), seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return (rng.standard_normal(shape) * 1000).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


def _bytes(path):
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_convention_round_trip_across_packages(tmp_path, dtype, suffix):
    vol = _volume(dtype)
    pj, pp = str(tmp_path / f"jax{suffix}"), str(tmp_path / f"port{suffix}")
    jnifti.write_nifti(pj, vol)
    pnifti.write_nifti(pp, vol)
    assert _bytes(pj) == _bytes(pp)
    for path in (pj, pp):
        got = pnifti.read_nifti(path)
        assert got.dtype == vol.dtype and got.shape == vol.shape
        np.testing.assert_array_equal(got, vol)
        np.testing.assert_array_equal(jnifti.read_nifti(path), got)


def test_raw_4d_rgb_and_affine_across_packages(tmp_path):
    """(x, y, z, 3) uint8, the RGB-coded gt of the reference's patches, with
    a non-identity affine."""
    rgb = _volume(np.uint8, (6, 4, 5, 3), seed=1)
    affine = np.diag([0.5, -2.0, 3.0, 1.0])
    affine[:3, 3] = (1.5, -7.0, 2.25)
    pj, pp = str(tmp_path / "j.nii"), str(tmp_path / "p.nii")
    jnifti.write_nifti_raw(pj, rgb, affine=affine)
    pnifti.write_nifti_raw(pp, rgb, affine=affine)
    assert _bytes(pj) == _bytes(pp)
    np.testing.assert_array_equal(pnifti.read_nifti_raw(pj), rgb)
    np.testing.assert_array_equal(jnifti.read_nifti_raw(pp), rgb)


def test_names_without_suffix_and_the_package_exports(tmp_path):
    """``write_nifti`` adds .nii.gz and ``read_nifti`` .nii to a bare name,
    as the JAX package's do; ``utils.io`` exports both."""
    vol = _volume(np.int16)
    pio.write_nifti(str(tmp_path / "a"), vol)
    jnifti.write_nifti(str(tmp_path / "b"), vol)
    assert _bytes(str(tmp_path / "a.nii.gz")) == _bytes(str(tmp_path / "b.nii.gz"))
    pnifti.write_nifti_raw(str(tmp_path / "c.nii"), np.swapaxes(vol, 0, 1))
    np.testing.assert_array_equal(pio.read_nifti(str(tmp_path / "c")), vol)


@pytest.mark.parametrize("damage", ["truncated", "magic", "dtype"])
def test_bad_files_raise_as_in_the_jax_package(tmp_path, damage):
    path = str(tmp_path / "v.nii")
    pnifti.write_nifti_raw(path, _volume(np.uint8))
    data = bytearray(_bytes(path))
    if damage == "truncated":
        data = data[:200]
    elif damage == "magic":
        data[344:348] = b"xyz\0"
    else:
        data[70:72] = (999).to_bytes(2, "little")
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError):
        jnifti.read_nifti_raw(path)
    with pytest.raises(ValueError):
        pnifti.read_nifti_raw(path)
    with pytest.raises(ValueError):
        pnifti.write_nifti_raw(str(tmp_path / "w.nii"), np.zeros((2, 2, 2), np.float16))


def test_run_inference_from_nifti_gives_jax_binaries(tmp_path):
    """The NIfTI entry point of stage 2 in parity on the CPU (precision
    'auto' there) against the JAX package's on the same .nii and .npz: the
    binaries equal and the .npy files byte for byte."""
    import torch

    from delivr_cfos_tpu.pipeline.stage02_inference import (
        run_inference_from_nifti as jax_run,
    )
    from delivr_cfos_tpu_torch.models.basic_unet import BasicUNetConfig, init_state_dict
    from delivr_cfos_tpu_torch.models.convert import (
        jax_params_from_state_dict,
        save_params_npz,
    )
    from delivr_cfos_tpu_torch.pipeline.stage02_inference import run_inference_from_nifti

    torch.set_num_threads(1)
    cfg = BasicUNetConfig(features=(4, 4, 8, 16, 32, 4))
    weights = str(tmp_path / "w.npz")
    save_params_npz(weights, jax_params_from_state_dict(
        init_state_dict(cfg, torch.Generator().manual_seed(4))))
    rng = np.random.default_rng(2)
    zyx = (rng.random((24, 40, 36)) * 300 + 10).astype(np.uint16)
    for c in rng.integers((2, 3, 3), (22, 37, 33), (12, 3)):
        zyx[c[0] - 1:c[0] + 1, c[1] - 3:c[1] + 3, c[2] - 3:c[2] + 3] = 50000
    nii = str(tmp_path / "brain.nii")
    pnifti.write_nifti(nii, np.transpose(zyx, (1, 2, 0)))  # (z, y, x) → (y, x, z)
    kw = dict(window=(16, 16, 16), threshold=0.6)
    ours = run_inference_from_nifti(nii, weights, str(tmp_path / "port.npy"),
                                    device="cpu", **kw)
    theirs = jax_run(nii, weights, str(tmp_path / "jax.npy"), **kw)
    assert ours.shape == zyx.shape and ours.dtype == np.uint8
    assert 0 < int(ours.sum()) < ours.size
    np.testing.assert_array_equal(ours, theirs)
    assert _bytes(str(tmp_path / "port.npy")) == _bytes(str(tmp_path / "jax.npy"))
