"""The port's connected-components engines (ops/connected_components.py,
native/cc.py) against the JAX package's on the same seeded volumes, and
against the checks of tests/test_connected_components.py,
tests/test_native_cc.py and tests/test_out_of_core_cc.py (the sharded
labeler goes with the multi-GPU item and is not ported).

Labels, component counts and integer statistics must be exactly equal;
centroids are float64 sums of integer coordinates divided once, so they are
equal too wherever both sides compute them alike."""

import numpy as np
import pytest
from scipy import ndimage

from delivr_cfos_tpu.ops import connected_components as jcc
from delivr_cfos_tpu_torch.native.build import native_available
from delivr_cfos_tpu_torch.native.cc import cc_label_native, cc_statistics_native
from delivr_cfos_tpu_torch.ops.connected_components import (
    apply_remap,
    component_statistics,
    component_statistics_streaming,
    label_out_of_core,
    label_slabs_streaming,
    label_volume_device,
    label_volume_host,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _random_blobs(shape=(40, 40, 40), density=0.08, seed=0):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.uint8)
    n_seeds = int(np.prod(shape) * density / 30)
    for _ in range(max(n_seeds, 5)):
        c = rng.integers(3, np.array(shape) - 3)
        r = rng.integers(1, 4)
        zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
        ball = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= r**2
        vol[ball] = 1
    return vol


def _blobby_volume(shape=(70, 40, 40), n_seeds=60, seed=0):
    """Random boxes, several spanning slab boundaries, and a rod through
    every z-slab."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.uint8)
    for _ in range(n_seeds):
        z, y, x = (rng.integers(0, s) for s in shape)
        dz, dy, dx = rng.integers(1, 6, 3)
        vol[z : z + dz, y : y + dy, x : x + dx] = 1
    vol[:, 20, 20] = 1
    return vol


def _noise(shape, threshold, seed):
    return (np.random.default_rng(seed).random(shape) > threshold).astype(np.uint8)


def _assert_stats_equal(got, want):
    np.testing.assert_array_equal(got["voxel_counts"], want["voxel_counts"])
    np.testing.assert_array_equal(got["centroids"], want["centroids"])
    np.testing.assert_array_equal(got["bounding_boxes"], want["bounding_boxes"])


VOLUMES = {
    "blobs": lambda: _random_blobs(seed=1),
    "dense": lambda: _noise((24, 24, 24), 0.6, 2),
    "sparse": lambda: _noise((30, 28, 26), 0.9, 3),
    "boxes_and_rod": lambda: _blobby_volume(seed=4),
}


def test_host_labeling_is_26_connected():
    vol = np.zeros((4, 4, 4), np.uint8)
    vol[0, 0, 0] = 1
    vol[1, 1, 1] = 1  # diagonal touch = connected under 26-connectivity
    assert label_volume_host(vol)[1] == 1
    vol[3, 3, 3] = 1  # isolated
    assert label_volume_host(vol)[1] == 2
    assert label_volume_device(vol, "cpu")[1] == 2


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_host_engine_matches_jax(name):
    vol = VOLUMES[name]()
    labels, n = label_volume_host(vol)
    want, n_want = jcc.label_volume_host(vol)
    assert n == n_want
    np.testing.assert_array_equal(labels, want)
    _assert_stats_equal(component_statistics(labels, n),
                        jcc.component_statistics(want, n_want))


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_device_labeler_on_the_cpu_matches_jax_and_the_host(name):
    vol = VOLUMES[name]()
    labels, n, rounds = label_volume_device(vol, "cpu", return_rounds=True)
    want, n_want = jcc.label_volume_device(vol)
    assert n == n_want
    np.testing.assert_array_equal(labels, want)
    host, n_host = label_volume_host(vol)
    assert n == n_host
    np.testing.assert_array_equal(labels, host)
    assert rounds >= 1


def test_device_labeler_takes_a_tensor():
    import torch

    vol = _noise((9, 10, 11), 0.5, 5)
    labels, n = label_volume_device(torch.from_numpy(vol), "cpu")
    want, n_want = label_volume_host(vol)
    assert n == n_want
    np.testing.assert_array_equal(labels, want)


def test_statistics_match_manual():
    vol = np.zeros((10, 10, 10), np.uint8)
    vol[1:3, 1:3, 1:3] = 1  # 8 voxels, centroid (1.5, 1.5, 1.5)
    vol[7, 7, 7] = 1  # 1 voxel
    labels, n = label_volume_host(vol)
    stats = component_statistics(labels, n)
    assert n == 2
    assert stats["voxel_counts"][1] == 8
    assert stats["voxel_counts"][2] == 1
    np.testing.assert_allclose(stats["centroids"][1], [1.5, 1.5, 1.5])
    np.testing.assert_allclose(stats["centroids"][2], [7, 7, 7])
    np.testing.assert_array_equal(stats["bounding_boxes"][1], [1, 2, 1, 2, 1, 2])


def test_statistics_match_scipy_reference():
    vol = _random_blobs(seed=3)
    labels, n = label_volume_host(vol)
    stats = component_statistics(labels, n)
    idx = np.arange(1, n + 1)
    counts_ref = ndimage.sum_labels(np.ones_like(labels), labels, idx)
    np.testing.assert_array_equal(stats["voxel_counts"][1:], counts_ref)
    cent_ref = np.array(ndimage.center_of_mass(vol, labels, idx))
    np.testing.assert_allclose(stats["centroids"][1:], cent_ref)


@pytest.mark.parametrize("slab_z", [5, 8, 13])
def test_slab_streaming_equals_global_and_jax(slab_z):
    vol = _random_blobs(shape=(37, 30, 30), seed=4)
    gl, gn = label_volume_host(vol)

    def slabs():
        for z0 in range(0, vol.shape[0], slab_z):
            yield z0, vol[z0 : z0 + slab_z]

    slab_list, remap, n = label_slabs_streaming(slabs())
    assert n == gn
    merged = np.concatenate([apply_remap(glob, remap) for _, glob in slab_list], axis=0)
    np.testing.assert_array_equal(merged, gl)
    j_slabs, j_remap, j_n = jcc.label_slabs_streaming(slabs())
    assert j_n == n and j_remap == remap
    for (z, glob), (jz, jglob) in zip(slab_list, j_slabs):
        assert z == jz
        np.testing.assert_array_equal(glob, jglob)


def test_empty_volume():
    vol = np.zeros((8, 8, 8), np.uint8)
    labels, n = label_volume_host(vol)
    assert n == 0
    stats = component_statistics(labels, n)
    assert stats["voxel_counts"].shape == (1,)
    ld, nd = label_volume_device(vol, "cpu")
    assert nd == 0 and ld.max() == 0
    out = np.zeros(vol.shape, np.int32)
    n_ooc, st = label_out_of_core(vol, out, slab_planes=3)
    assert n_ooc == 0 and out.max() == 0
    assert st["voxel_counts"][0] == vol.size


def test_device_labeler_rejects_int32_overflow_volumes():
    """Device labels are int32 linear voxel indices; a >=2^31-voxel volume
    is refused before any transfer."""
    huge = np.broadcast_to(np.zeros((1, 1, 1), np.uint8), (2048, 1024, 1024))
    with pytest.raises(ValueError, match="int32 label space"):
        label_volume_device(huge, "cpu")


# ---- native engine (tests/test_native_cc.py) -----------------------------


@pytest.fixture
def native():
    if not native_available():
        pytest.skip("g++ toolchain unavailable")


@pytest.mark.parametrize("threshold,shape,seed", [
    (0.55, (30, 40, 25), 0),
    (0.97, (50, 50, 50), 1),
])
def test_native_labeling_matches_scipy_and_jax(native, threshold, shape, seed):
    """The port's C++ union-find against the port's scipy host engine and
    the JAX package's host engine (``jcc.label_volume_host``, scipy).

    The JAX package's own native library is not called: it is built
    straight onto its final path, so a test worker can load a file that
    another worker's linker is still writing and then lose that library for
    the rest of its life. JAX native against scipy is held by
    tests/test_native_cc.py; port host against JAX host by
    test_host_engine_matches_jax."""
    vol = _noise(shape, threshold, seed)
    ln, nn = cc_label_native(vol)
    lh, nh = label_volume_host(vol)
    assert nn == nh
    np.testing.assert_array_equal(ln, lh)
    lj, nj = jcc.label_volume_host(vol)
    assert nj == nn
    np.testing.assert_array_equal(lj, ln)


def test_native_statistics_match_numpy(native):
    vol = _noise((20, 20, 20), 0.6, 2)
    labels, n = cc_label_native(vol)
    ours = cc_statistics_native(labels, n)
    ref = component_statistics(labels, n)
    np.testing.assert_array_equal(ours["voxel_counts"], ref["voxel_counts"])
    np.testing.assert_allclose(ours["centroids"][1:], ref["centroids"][1:], rtol=1e-12)
    np.testing.assert_array_equal(ours["bounding_boxes"][1:], ref["bounding_boxes"][1:])


def test_native_empty(native):
    labels, n = cc_label_native(np.zeros((5, 5, 5), np.uint8))
    assert n == 0 and labels.max() == 0


# ---- out of core (tests/test_out_of_core_cc.py) --------------------------


@pytest.mark.parametrize("slab_planes", [7, 16, 64, 200])
def test_label_out_of_core_matches_host_and_jax(slab_planes):
    vol = _blobby_volume()
    ref_labels, ref_n = label_volume_host(vol)
    ref_stats = component_statistics(ref_labels, ref_n)
    labels_out = np.zeros(vol.shape, np.int32)
    n, stats = label_out_of_core(vol, labels_out, slab_planes=slab_planes,
                                 label_fn=label_volume_host)
    assert n == ref_n
    np.testing.assert_array_equal(labels_out, ref_labels)
    np.testing.assert_array_equal(stats["voxel_counts"], ref_stats["voxel_counts"])
    np.testing.assert_allclose(stats["centroids"], ref_stats["centroids"])
    np.testing.assert_array_equal(stats["bounding_boxes"], ref_stats["bounding_boxes"])
    j_out = np.zeros(vol.shape, np.int32)
    j_n, j_stats = jcc.label_out_of_core(vol, j_out, slab_planes=slab_planes,
                                         label_fn=jcc.label_volume_host)
    assert j_n == n
    np.testing.assert_array_equal(j_out, labels_out)
    _assert_stats_equal(stats, j_stats)


def test_label_out_of_core_parallel_bit_identical():
    """workers > 1 fans the per-slab labeling over a thread pool; labels AND
    stats must be bit-identical to the serial path."""
    vol = _blobby_volume(shape=(90, 40, 40), n_seeds=120, seed=8)
    ser = np.zeros(vol.shape, np.int32)
    n_ser, st_ser = label_out_of_core(vol, ser, slab_planes=7, workers=1)
    par = np.zeros(vol.shape, np.int32)
    n_par, st_par = label_out_of_core(vol, par, slab_planes=7, workers=4)
    assert n_par == n_ser
    np.testing.assert_array_equal(par, ser)
    _assert_stats_equal(st_par, st_ser)


def test_label_out_of_core_worker_error_propagates():
    """A label_fn failure on a worker thread surfaces on the caller."""

    def boom(vol):
        raise RuntimeError("label_fn failed")

    vol = _blobby_volume(shape=(40, 24, 24), seed=9)
    with pytest.raises(RuntimeError, match="label_fn failed"):
        label_out_of_core(vol, np.zeros(vol.shape, np.int32), slab_planes=8,
                          label_fn=boom, workers=3)


def test_component_statistics_streaming_matches():
    vol = _blobby_volume(seed=3)
    labels, n = label_volume_host(vol)
    ref = component_statistics(labels, n)
    st = component_statistics_streaming(labels, n, slab_planes=9)
    np.testing.assert_array_equal(st["voxel_counts"], ref["voxel_counts"])
    np.testing.assert_allclose(st["centroids"], ref["centroids"])
    np.testing.assert_array_equal(st["bounding_boxes"], ref["bounding_boxes"])
    _assert_stats_equal(st, jcc.component_statistics_streaming(labels, n, slab_planes=9))
