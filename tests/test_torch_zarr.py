"""The port's zarr v2 codec (delivr_cfos_tpu_torch/utils/io/zarr.py) against
the JAX package's, and the port's streaming engine on a zarr volume.

Mirrors tests/test_zarr.py case by case (roundtrip over compressors, true
gzip, partial reads, missing-chunk fill, the '/' separator, streaming), and
adds: stores written by each package read by the other; the two writers'
store trees equal byte for byte (zlib at level 1 is deterministic); what
both readers refuse; and a streamed run from a ``ZarrVolume`` equal to the
bit to the same run from an ``np.memmap`` of the same array.

Streaming runs in parity on the CPU: within 1e-4 of the port's in-memory
engine (tests/test_zarr.py's bound) and within 2e-4 of the JAX streaming
engine on the same store, with the weights carried across."""

import gzip
import json
import os

import numpy as np
import pytest

import torch

from delivr_cfos_tpu.engine import sliding_window as jsw
from delivr_cfos_tpu.engine.streaming import infer_volume_streaming as jax_streaming
from delivr_cfos_tpu.models.basic_unet import BasicUNetConfig as JaxConfig
from delivr_cfos_tpu.models.convert import torch_state_dict_to_params
from delivr_cfos_tpu.utils.io.zarr import ZarrVolume as JaxZarrVolume
from delivr_cfos_tpu.utils.io.zarr import write_zarr as jax_write_zarr
from delivr_cfos_tpu_torch.engine.sliding_window import SlidingWindowConfig, infer_volume
from delivr_cfos_tpu_torch.engine.streaming import infer_volume_streaming
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    build_model,
    init_state_dict,
)
from delivr_cfos_tpu_torch.utils.io import ZarrVolume, write_zarr
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)
PORT_CFG = BasicUNetConfig(features=TINY)
COMPRESSORS = (None, "zlib", "gzip")


def _tree(path):
    """{relative path: bytes} of every file under a store."""
    out = {}
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _half_bright(shape, seed):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.uint16)
    vol[:, : shape[1] // 2] = (
        rng.random((shape[0], shape[1] // 2, shape[2])) * 700
    ).astype(np.uint16)
    return vol


@pytest.mark.parametrize("comp", COMPRESSORS)
def test_zarr_roundtrip_compressors(tmp_path, comp):
    rng = np.random.default_rng(0)
    arr = (rng.random((37, 22, 15)) * 1000).astype(np.uint16)
    p = str(tmp_path / f"a_{comp}")
    assert write_zarr(p, arr, chunks=(16, 8, 8), compressor=comp) == p
    z = ZarrVolume(p)
    assert z.shape == arr.shape and z.dtype == arr.dtype and z.ndim == 3
    assert z.chunks == (16, 8, 8) and z.nbytes == arr.nbytes
    np.testing.assert_array_equal(np.asarray(z), arr)
    np.testing.assert_array_equal(np.asarray(z, dtype=np.float32), arr.astype(np.float32))


def test_zarr_gzip_chunks_are_true_gzip(tmp_path):
    """A 'gzip' compressor id gives gzip-framed chunks (magic 1f 8b), which
    Python's gzip module decodes."""
    rng = np.random.default_rng(2)
    arr = (rng.random((10, 8)) * 255).astype(np.uint8)
    p = str(tmp_path / "g")
    write_zarr(p, arr, chunks=(10, 8), compressor="gzip")
    chunk = [f for f in os.listdir(p) if not f.startswith(".")][0]
    raw = open(os.path.join(p, chunk), "rb").read()
    assert raw[:2] == b"\x1f\x8b"
    assert gzip.decompress(raw) == arr.tobytes()
    np.testing.assert_array_equal(np.asarray(ZarrVolume(p)), arr)


def test_zarr_partial_reads(tmp_path):
    """The slices of tests/test_zarr.py, equal to numpy's and to the JAX
    reader's on the same store; a strided read raises in both."""
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((40, 30, 20)).astype(np.float32)
    p = str(tmp_path / "b")
    write_zarr(p, arr, chunks=(7, 9, 20))
    z, jz = ZarrVolume(p), JaxZarrVolume(p)
    for key in (np.s_[3:25], np.s_[5:6, 2:29, 3:17], 12, np.s_[:, 4],
                np.s_[-3], np.s_[38:40, -9:, 19], np.s_[10:10]):
        got = z[key]
        np.testing.assert_array_equal(got, arr[key])
        np.testing.assert_array_equal(got, jz[key])
        assert got.shape == arr[key].shape and got.flags.c_contiguous
    for reader in (z, jz):
        with pytest.raises(NotImplementedError, match="strided"):
            reader[::2]


def test_zarr_missing_chunks_fill(tmp_path):
    """A missing chunk reads as the store's fill_value (0 as written, and 7
    after editing .zarray), in both readers."""
    arr = np.ones((8, 8), np.int32)
    p = str(tmp_path / "c")
    write_zarr(p, arr, chunks=(4, 4), compressor=None)
    os.remove(os.path.join(p, "1.1"))
    got = np.asarray(ZarrVolume(p))
    assert (got[:4, :4] == 1).all()
    assert (got[4:, 4:] == 0).all()
    meta_path = os.path.join(p, ".zarray")
    meta = json.load(open(meta_path))
    meta["fill_value"] = 7
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    got = np.asarray(ZarrVolume(p))
    assert (got[4:, 4:] == 7).all() and (got[:4] == 1).all()
    np.testing.assert_array_equal(got, np.asarray(JaxZarrVolume(p)))


def test_zarr_dimension_separator_slash(tmp_path):
    arr = np.arange(24, dtype=np.uint8).reshape(4, 6)
    p = str(tmp_path / "d")
    write_zarr(p, arr, chunks=(2, 3), dimension_separator="/")
    # chunk files live in subdirectories
    assert os.path.isfile(os.path.join(p, "0", "0"))
    np.testing.assert_array_equal(np.asarray(ZarrVolume(p)), arr)


@pytest.mark.parametrize("sep", [".", "/"])
@pytest.mark.parametrize("comp", COMPRESSORS)
def test_zarr_stores_read_across_packages(tmp_path, comp, sep):
    """A store written by either package reads the same in the other."""
    rng = np.random.default_rng(3)
    arr = (rng.random((19, 13, 11)) * 60000).astype(np.uint16)
    kw = dict(chunks=(8, 5, 11), compressor=comp, dimension_separator=sep)
    write_zarr(str(tmp_path / "port"), arr, **kw)
    jax_write_zarr(str(tmp_path / "jax"), arr, **kw)
    np.testing.assert_array_equal(np.asarray(JaxZarrVolume(str(tmp_path / "port"))), arr)
    np.testing.assert_array_equal(np.asarray(ZarrVolume(str(tmp_path / "jax"))), arr)
    np.testing.assert_array_equal(ZarrVolume(str(tmp_path / "jax"))[4:17, 3], arr[4:17, 3])


@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.int8])
@pytest.mark.parametrize("comp", COMPRESSORS)
def test_zarr_writers_give_equal_bytes(tmp_path, comp, dtype):
    """The same array, chunks and compressor give byte-equal store trees:
    .zarray and every chunk file, edge chunks padded alike."""
    rng = np.random.default_rng(4)
    arr = (rng.standard_normal((21, 9, 14)) * 50).astype(dtype)
    write_zarr(str(tmp_path / "port"), arr, chunks=(8, 4, 6), compressor=comp)
    jax_write_zarr(str(tmp_path / "jax"), arr, chunks=(8, 4, 6), compressor=comp)
    port, ref = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert len(port) == 1 + 3 * 3 * 3
    assert port == ref
    # and with the default chunks of 64 and the '/' separator
    write_zarr(str(tmp_path / "p2"), arr, compressor=comp, dimension_separator="/")
    jax_write_zarr(str(tmp_path / "j2"), arr, compressor=comp, dimension_separator="/")
    assert _tree(str(tmp_path / "p2")) == _tree(str(tmp_path / "j2"))


@pytest.mark.parametrize("edit,error", [
    ({"zarr_format": 3}, ValueError),
    ({"order": "F"}, NotImplementedError),
    ({"filters": [{"id": "delta", "dtype": "<u2"}]}, NotImplementedError),
    ({"compressor": {"id": "blosc", "cname": "lz4"}}, NotImplementedError),
])
def test_zarr_refuses_what_it_does_not_read(tmp_path, edit, error):
    """v2 only, C order, no filters, none/zlib/gzip: both readers raise the
    same error; the writers refuse an unknown compressor."""
    p = str(tmp_path / "e")
    write_zarr(p, np.zeros((4, 4), np.uint8), chunks=(2, 2))
    meta = json.load(open(os.path.join(p, ".zarray")))
    meta.update(edit)
    with open(os.path.join(p, ".zarray"), "w") as f:
        json.dump(meta, f)
    for reader in (ZarrVolume, JaxZarrVolume):
        with pytest.raises(error):
            reader(p)
    with pytest.raises(NotImplementedError):
        write_zarr(str(tmp_path / "f"), np.zeros(3), compressor="blosc")


@pytest.fixture(scope="module")
def weights():
    sd = init_state_dict(PORT_CFG, torch.Generator().manual_seed(5))
    return build_model(sd, PORT_CFG, "cpu"), torch_state_dict_to_params(sd)


def test_streaming_inference_from_zarr(tmp_path, weights):
    """The streaming engine takes a ZarrVolume through the array protocol:
    within 1e-4 of the port's in-memory run, and within 2e-4 of the JAX
    streaming engine on the same store and weights."""
    model, params = weights
    vol = _half_bright((48, 32, 32), 2)
    p = str(tmp_path / "vol.zarr")
    write_zarr(p, vol, chunks=(16, 16, 16))
    z = ZarrVolume(p)

    cfg = SlidingWindowConfig(roi=(16, 16, 16), overlap=0.5, batch_size=4, tta=False)
    logits = np.empty(vol.shape, np.float32)
    infer_volume_streaming(model, z, cfg, PORT_CFG, slab_z_starts=2, logits_out=logits)
    mean_whole, _ = infer_volume(model, vol, cfg, PORT_CFG, return_binary=False)
    np.testing.assert_allclose(logits, mean_whole.numpy(), rtol=1e-4, atol=1e-4)

    j_logits = np.empty(vol.shape, np.float32)
    jax_streaming(params, JaxZarrVolume(p),
                  jsw.SlidingWindowConfig(roi=(16, 16, 16), overlap=0.5,
                                          batch_size=4, tta=False),
                  JaxConfig(features=TINY), slab_z_starts=2, logits_out=j_logits)
    np.testing.assert_allclose(logits, j_logits, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("prefetch", [True, False])
def test_streaming_from_zarr_equals_streaming_from_a_memmap(tmp_path, weights, prefetch):
    """The input's container does not matter: a zlib store in chunks that
    cut across slabs gives the memmap run's logits and binaries to the bit,
    also with TTA noise and erosion."""
    model, _ = weights
    vol = _half_bright((56, 32, 24), 6)
    p = str(tmp_path / "vol.zarr")
    write_zarr(p, vol, chunks=(12, 20, 16))
    mm = np.lib.format.open_memmap(str(tmp_path / "vol.npy"), mode="w+",
                                   dtype=vol.dtype, shape=vol.shape)
    mm[:] = vol
    mm.flush()
    cfg = SlidingWindowConfig(roi=(16, 16, 16), batch_size=4, tta=True, seed=3,
                              erosion_iters=2)
    runs = []
    for src in (ZarrVolume(p), np.load(str(tmp_path / "vol.npy"), mmap_mode="r")):
        logits = np.empty(vol.shape, np.float32)
        bins, _ = infer_volume_streaming(model, src, cfg, PORT_CFG, slab_z_starts=2,
                                         logits_out=logits, prefetch=prefetch)
        runs.append((bins, logits))
    (zb, zl), (mb, ml) = runs
    assert np.array_equal(zl, ml) and np.array_equal(zb, mb)
    assert zb.any() and np.isfinite(zl).all()
