"""The port's sharded labeler (``parallel/sharded_cc.py``) on meshes of CPU
devices, under the stress shapes of tests/test_sharded_cc_stress.py:
components that cross many shard boundaries, the worst cases of shard-local
pointer jumping, and a randomized volume against the out-of-core engine.
Labels and counts must equal the port's host engine's and the JAX package's
scipy labels (``label_volume_host``; never its native library). One case
runs the JAX package's own sharded labeler (a shard_map compile): ``slow``.
"""

import numpy as np
import pytest

from delivr_cfos_tpu.ops.connected_components import label_volume_host as jax_label_host
from delivr_cfos_tpu_torch.ops.connected_components import (
    component_statistics,
    label_out_of_core,
    label_volume_host,
)
from delivr_cfos_tpu_torch.parallel.mesh import make_mesh
from delivr_cfos_tpu_torch.parallel.sharded_cc import label_volume_sharded
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _cpu_mesh(n):
    return make_mesh({"sp": n}, devices=["cpu"] * n)


def _assert_matches_host(vol, n_sp=8):
    want_labels, want_n = label_volume_host(vol)
    jax_labels, jax_n = jax_label_host(vol)
    got_labels, got_n, rounds = label_volume_sharded(_cpu_mesh(n_sp), vol, return_rounds=True)
    assert got_n == want_n == jax_n and rounds >= 1
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_array_equal(got_labels, jax_labels)
    return got_labels, rounds


def test_rod_spans_all_eight_shards():
    """A straight rod through every shard, and a 26-connected diagonal
    staircase crossing every boundary obliquely."""
    vol = np.zeros((64, 16, 16), np.uint8)
    vol[:, 4, 4] = 1
    z = np.arange(64)
    vol[z, (2 + z) % 16, (1 + 2 * z) % 16] = 1
    _assert_matches_host(vol)


def test_snake_forces_many_halo_rounds():
    """The raster-minimum voxel is at z = 0 of the up column; the down
    column's z = 0 voxel learns it only after it travels 0 → 63 → 0: at
    least 2 × 7 boundary crossings, one a round."""
    vol = np.zeros((64, 8, 12), np.uint8)
    vol[:, 4, 2] = 1
    vol[63, 4, 2:10] = 1
    vol[:, 4, 9] = 1
    _, rounds = _assert_matches_host(vol)
    assert rounds > 14


def test_comb_many_components_crossing_boundaries():
    vol = np.zeros((64, 12, 32), np.uint8)
    for i, x in enumerate(range(0, 32, 2)):
        z0 = (i % 3) * 8
        vol[z0 : z0 + 40, 6, x] = 1
    _assert_matches_host(vol)


@pytest.mark.parametrize("n_sp", [3, 8])
def test_randomized_equivalence_vs_out_of_core(tmp_path, n_sp):
    """Randomized volume with rods stitching shards, z not a multiple of
    the shard count for n_sp 3 (padded last slab): equal to the host and the
    out-of-core engines, whose slab cuts (64) differ from the shards'."""
    rng = np.random.default_rng(42)
    vol = (rng.random((256, 24, 20)) > 0.72).astype(np.uint8)
    for x in range(0, 20, 7):
        vol[:, 11, x] = 1
    got_labels, _ = _assert_matches_host(vol, n_sp)
    ooc = np.lib.format.open_memmap(str(tmp_path / "labels.npy"), mode="w+",
                                    dtype=np.int32, shape=vol.shape)
    ooc_n, ooc_stats = label_out_of_core(vol, ooc, slab_planes=64)
    np.testing.assert_array_equal(np.asarray(ooc), got_labels)
    stats = component_statistics(got_labels, ooc_n)
    np.testing.assert_array_equal(stats["voxel_counts"], ooc_stats["voxel_counts"])


def test_empty_and_single_shard():
    vol = np.zeros((10, 8, 8), np.uint8)
    labels, n = label_volume_sharded(_cpu_mesh(4), vol)
    assert n == 0 and not labels.any()
    vol[2:5, 3, 3] = 1
    vol[8, 0, 0] = 1
    labels, n = label_volume_sharded(_cpu_mesh(1), vol)
    np.testing.assert_array_equal(labels, label_volume_host(vol)[0])


def test_sharded_labeler_rejects_int32_overflow_volumes():
    """Global labels are int32 linear voxel indices: a volume of 2^31 voxels
    or more is refused before any copy to a device."""
    huge = np.broadcast_to(np.zeros((1, 1, 1), np.uint8), (2048, 1024, 1024))
    with pytest.raises(ValueError, match="int32 global label space"):
        label_volume_sharded(_cpu_mesh(8), huge)


@pytest.mark.slow  # the JAX package's sharded labeler compiles a shard_map
def test_matches_the_jax_sharded_labeler():
    from delivr_cfos_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from delivr_cfos_tpu.parallel.sharded_cc import label_volume_sharded as jax_sharded

    rng = np.random.default_rng(5)
    vol = (rng.random((64, 16, 16)) > 0.7).astype(np.uint8)
    want, want_n = jax_sharded(jax_make_mesh({"sp": 8}), vol)
    got, got_n = label_volume_sharded(_cpu_mesh(8), vol)
    assert got_n == want_n
    np.testing.assert_array_equal(got, want)
