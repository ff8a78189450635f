"""The port's NRRD codec (delivr_cfos_tpu_torch/utils/io/nrrd.py): the
round trips and header cases of tests/test_nrrd.py, and byte equality with
the JAX package's writer and reader in both directions."""

import gzip

import numpy as np
import pytest

from delivr_cfos_tpu.utils.io.nrrd import read_nrrd as jax_read_nrrd
from delivr_cfos_tpu.utils.io.nrrd import write_nrrd as jax_write_nrrd
from delivr_cfos_tpu_torch.utils.io.nrrd import read_nrrd, write_nrrd


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32, np.int32])
@pytest.mark.parametrize("encoding", ["raw", "gzip"])
def test_roundtrip(tmp_path, dtype, encoding):
    arr = (np.random.default_rng(0).random((9, 7, 5)) * 200).astype(dtype)
    p = str(tmp_path / "a.nrrd")
    write_nrrd(p, arr, encoding=encoding)
    back, header = read_nrrd(p)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, arr)
    assert header["sizes"] == "5 7 9"


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.uint32, np.float64])
@pytest.mark.parametrize("encoding", ["raw", "gzip"])
def test_files_equal_the_jax_packages(tmp_path, dtype, encoding):
    arr = (np.random.default_rng(1).random((6, 4, 11)) * 100).astype(dtype)
    port, jax = str(tmp_path / "port.nrrd"), str(tmp_path / "jax.nrrd")
    write_nrrd(port, arr, encoding=encoding, extra={"space": "left-posterior-superior"})
    jax_write_nrrd(jax, arr, encoding=encoding, extra={"space": "left-posterior-superior"})
    assert open(port, "rb").read() == open(jax, "rb").read()
    for a, b in ((read_nrrd(jax), jax_read_nrrd(jax)), (read_nrrd(port), jax_read_nrrd(port))):
        assert a[0].dtype == b[0].dtype
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


def test_reads_allen_style_header(tmp_path):
    """Hand-built header in the Allen informatics-archive style (gzip,
    little endian, space directions present but ignored)."""
    arr = np.arange(24, dtype=np.uint16).reshape(2, 3, 4)
    payload = gzip.compress(arr.astype("<u2").tobytes())
    header = (
        b"NRRD0004\n"
        b"# Complete NRRD file format specification at:\n"
        b"type: unsigned short\n"
        b"dimension: 3\n"
        b"space: left-posterior-superior\n"
        b"sizes: 4 3 2\n"
        b"space directions: (50,0,0) (0,50,0) (0,0,50)\n"
        b"kinds: domain domain domain\n"
        b"endian: little\n"
        b"encoding: gzip\n"
        b"space origin: (0,0,0)\n"
        b"\n"
    )
    p = tmp_path / "allen.nrrd"
    p.write_bytes(header + payload)
    back, hdr = read_nrrd(str(p))
    np.testing.assert_array_equal(back, arr)
    assert hdr["space"] == "left-posterior-superior"


def test_reads_big_endian(tmp_path):
    arr = np.arange(30, dtype=np.int16).reshape(2, 3, 5) - 7
    p = tmp_path / "be.nrrd"
    p.write_bytes(b"NRRD0005\ntype: short\ndimension: 3\nsizes: 5 3 2\nendian: big\n"
                  b"encoding: raw\n\n" + arr.astype(">i2").tobytes())
    back, _ = read_nrrd(str(p))
    assert back.dtype == np.int16
    np.testing.assert_array_equal(back, arr)


def test_rejects_non_nrrd(tmp_path):
    p = tmp_path / "x.nrrd"
    p.write_bytes(b"not a nrrd\n\n")
    with pytest.raises(ValueError):
        read_nrrd(str(p))
