"""The port's TIFF and v3draw codecs (utils/io/tiff.py, utils/io/v3draw.py,
native/tiff.py) on the TIFF and v3draw cases of tests/test_io.py, and
against the JAX package's codecs: files written by one package are read by
the other, and both write the same bytes.

The JAX package's side is reached only through its public readers and
writers: they decode LZW and PackBits natively where their library loads,
and through their Python decoders where it does not, with the same pixels
either way. Everything is held exactly.
"""

import numpy as np
import pytest

from delivr_cfos_tpu.utils.io.tiff import read_tiff as jax_read_tiff
from delivr_cfos_tpu.utils.io.tiff import write_tiff as jax_write_tiff
from delivr_cfos_tpu.utils.io.v3draw import read_v3draw as jax_read_v3draw
from delivr_cfos_tpu.utils.io.v3draw import write_v3draw as jax_write_v3draw
from delivr_cfos_tpu_torch.native.build import native_available
from delivr_cfos_tpu_torch.native.tiff import decode_native
from delivr_cfos_tpu_torch.utils.io.tiff import (
    _lzw_decode,
    _packbits_decode,
    read_tiff,
    tiff_page_infos,
    write_tiff,
    write_tiff_stack,
)
from delivr_cfos_tpu_torch.utils.io.v3draw import read_v3draw, write_v3draw
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def native_tiff():
    if not native_available("tiff_codec"):
        pytest.skip("native TIFF codec unavailable (no g++)")


# ---- tests/test_io.py's TIFF cases, on the port ---------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_tiff_roundtrip_gray(tmp_path, dtype):
    rng = np.random.default_rng(0)
    img = (rng.random((37, 53)) * 200).astype(dtype)
    p = str(tmp_path / "img.tif")
    write_tiff(p, img)
    back = read_tiff(p)
    assert back.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(back, img)


def test_tiff_roundtrip_gray_compressed(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.random((64, 80)) * 65535).astype(np.uint16)
    p = str(tmp_path / "img.tif")
    write_tiff(p, img, compress=True)
    np.testing.assert_array_equal(read_tiff(p), img)


def test_tiff_roundtrip_rgb(tmp_path):
    rng = np.random.default_rng(2)
    img = (rng.random((21, 33, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "rgb.tif")
    write_tiff(p, img)
    np.testing.assert_array_equal(read_tiff(p), img)


def test_tiff_multipage_stack(tmp_path):
    rng = np.random.default_rng(3)
    stack = (rng.random((5, 17, 23)) * 65535).astype(np.uint16)
    p = str(tmp_path / "stack.tif")
    write_tiff_stack(p, stack)
    infos = tiff_page_infos(p)
    assert len(infos) == 5
    np.testing.assert_array_equal(read_tiff(p), stack)
    np.testing.assert_array_equal(infos[3].read(), stack[3])


def test_tiff_interop_with_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    img = (rng.random((40, 60)) * 65535).astype(np.uint16)
    p_cv, p_ours = str(tmp_path / "cv.tif"), str(tmp_path / "ours.tif")
    assert cv2.imwrite(p_cv, img)
    np.testing.assert_array_equal(read_tiff(p_cv), img)
    write_tiff(p_ours, img)
    np.testing.assert_array_equal(cv2.imread(p_ours, cv2.IMREAD_UNCHANGED), img)


def test_tiff_native_lzw_packbits_decoders(tmp_path, native_tiff):
    """The port's C++ strip codecs agree byte for byte with the Python
    decoders and read cv2/libtiff-written LZW and PackBits files."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(12)
    img = (
        np.linspace(0, 2000, 48 * 64).reshape(48, 64)
        + (rng.random((48, 64)) > 0.97) * 30000
    ).astype(np.uint16)
    for code, kind in ((5, "lzw"), (32773, "packbits")):
        p = str(tmp_path / f"c{code}.tif")
        assert cv2.imwrite(p, img, [cv2.IMWRITE_TIFF_COMPRESSION, code])
        np.testing.assert_array_equal(read_tiff(p), img)
        for info in tiff_page_infos(p):
            assert info.compression == code
            with open(p, "rb") as f:
                for off, cnt in zip(info.data_offsets, info.data_byte_counts):
                    f.seek(off)
                    raw = f.read(cnt)
                    ref = _lzw_decode(raw) if kind == "lzw" else _packbits_decode(raw)
                    got = decode_native(kind, raw, len(ref) + 16)
                    assert got is not None
                    assert bytes(got) == ref


def test_tiff_native_page_decode_odd_dims(tmp_path, native_tiff):
    """The one-call native page decoder handles odd dimensions (short last
    strip, odd row length) as libtiff reads them, and as the JAX package's
    reader does."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(13)
    for shape in ((45, 63), (7, 129), (201, 31)):
        img = (rng.random(shape) * 65535).astype(np.uint16)
        for code in (5, 32773):
            p = str(tmp_path / f"odd_{shape[0]}x{shape[1]}_{code}.tif")
            assert cv2.imwrite(p, img, [cv2.IMWRITE_TIFF_COMPRESSION, code])
            np.testing.assert_array_equal(read_tiff(p), img)
            np.testing.assert_array_equal(jax_read_tiff(p), img)


def test_tiff_interop_rgb_with_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    img = (rng.random((16, 24, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "rgb.tif")
    write_tiff(p, img)
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1], img)  # cv2 is BGR


def test_v3draw_roundtrip(tmp_path):
    rng = np.random.default_rng(8)
    vol = (rng.random((6, 10, 14)) * 65535).astype(np.uint16)
    p = str(tmp_path / "v.v3draw")
    write_v3draw(p, vol)
    np.testing.assert_array_equal(read_v3draw(p), vol)


# ---- the port against the JAX package --------------------------------------


def _images():
    rng = np.random.default_rng(20)
    return {
        "u8": (rng.random((19, 23)) * 255).astype(np.uint8),
        "u16": (rng.random((31, 17)) * 65535).astype(np.uint16),
        "f32": rng.random((9, 12)).astype(np.float32),
        "rgb": (rng.random((11, 13, 3)) * 255).astype(np.uint8),
        "stack": (rng.random((4, 15, 21)) * 65535).astype(np.uint16),
    }


@pytest.mark.parametrize("compress", [False, True])
def test_tiff_writes_are_byte_equal_and_cross_read(tmp_path, compress):
    for name, img in _images().items():
        ours, theirs = str(tmp_path / f"{name}_p.tif"), str(tmp_path / f"{name}_j.tif")
        write_tiff(ours, img, compress=compress)
        jax_write_tiff(theirs, img, compress=compress)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), name
        np.testing.assert_array_equal(read_tiff(theirs), img)
        np.testing.assert_array_equal(jax_read_tiff(ours), img)


def test_compressed_tiffs_of_other_writers_read_alike(tmp_path):
    """LZW and PackBits files (cv2/libtiff), and predictor 2: the port's
    reader and the JAX package's give the same pixels."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(21)
    img = (np.linspace(0, 5000, 70 * 90).reshape(70, 90)
           + (rng.random((70, 90)) > 0.9) * 20000).astype(np.uint16)
    for code in (5, 8, 32773):
        p = str(tmp_path / f"c{code}.tif")
        assert cv2.imwrite(p, img, [cv2.IMWRITE_TIFF_COMPRESSION, code])
        ours = read_tiff(p)
        np.testing.assert_array_equal(ours, img)
        np.testing.assert_array_equal(ours, jax_read_tiff(p))


def test_v3draw_byte_equal_and_cross_read(tmp_path):
    rng = np.random.default_rng(22)
    for dtype in (np.uint8, np.uint16, np.float32):
        vol = (rng.random((2, 5, 7, 9)) * 200).astype(dtype)
        ours, theirs = str(tmp_path / "p.v3draw"), str(tmp_path / "j.v3draw")
        write_v3draw(ours, vol)
        jax_write_v3draw(theirs, vol)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        np.testing.assert_array_equal(read_v3draw(theirs), vol)
        np.testing.assert_array_equal(jax_read_v3draw(ours), vol)
    with pytest.raises(ValueError, match="uint8/uint16/float32"):
        write_v3draw(ours, np.zeros((2, 2, 2), np.int32))
