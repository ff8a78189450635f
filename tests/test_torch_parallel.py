"""The port's device mesh and z-sharded sliding-window inference
(``delivr_cfos_tpu_torch/parallel/``) against the port's single-device
engine and the JAX package's, on meshes of CPU devices (``["cpu"] * n``, the
counterpart of the JAX tests' eight virtual devices).

Mirrors tests/test_sharded_inference.py and tests/test_distributed_init.py:
sharded mean logits within rtol = atol = 1e-4 of one device's for n_sp 2, 4
and 8, arbitrary z, TTA flips and shard_axis 1 and 2 (only the summation
order at shard boundaries differs), and of the JAX package's single-device
engine on the same weights at the same bound; the noise-TTA cases hold the
port to JAX's tests of independence and statistics, not to JAX's draws. The
host plans (``plan_sharding``, the per-shard starts, the brain deal and the
hybrid mesh's shape) equal JAX's. The distributed hook is held to the seven
cases of the JAX test with a spy in place of ``init_process_group``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from delivr_cfos_tpu.engine import sliding_window as jsw
from delivr_cfos_tpu.models.basic_unet import BasicUNetConfig as JaxConfig
from delivr_cfos_tpu.models.convert import torch_state_dict_to_params
from delivr_cfos_tpu.parallel import mesh as jmesh
from delivr_cfos_tpu.parallel import sharded_inference as jsi
from delivr_cfos_tpu_torch.engine import streaming as st
from delivr_cfos_tpu_torch.engine.sliding_window import SlidingWindowConfig, infer_volume
from delivr_cfos_tpu_torch.models.basic_unet import (
    BasicUNetConfig,
    build_model,
    init_state_dict,
)
from delivr_cfos_tpu_torch.parallel import make_mesh, plan_sharding, sharded_infer_volume
from delivr_cfos_tpu_torch.parallel import mesh as pmesh
from delivr_cfos_tpu_torch.parallel.sharded_inference import (
    _per_shard_starts,
    replicate,
    sharded_accumulate,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = (4, 4, 8, 16, 32, 4)
PORT_CFG = BasicUNetConfig(features=TINY)
JAX_CFG = JaxConfig(features=TINY)
ROI = (16, 16, 16)


@pytest.fixture(scope="module")
def weights():
    sd = init_state_dict(PORT_CFG, torch.Generator().manual_seed(3))
    return build_model(sd, PORT_CFG, "cpu"), torch_state_dict_to_params(sd)


def _volume(shape=(64, 32, 32), seed=0):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.uint16)
    vol[:, : shape[1] // 2] = (
        rng.random((shape[0], shape[1] // 2, shape[2])) * 900
    ).astype(np.uint16)
    return vol


def _cpu_mesh(n):
    return make_mesh({"sp": n}, devices=["cpu"] * n)


def _cfg(**kw):
    return SlidingWindowConfig(**{"roi": ROI, "overlap": 0.5, "batch_size": 4, **kw})


def _single(weights, vol, cfg):
    model, _ = weights
    return infer_volume(model, vol, cfg, PORT_CFG, return_binary=False)[0].numpy()


def _jax_single(weights, vol, cfg):
    _, params = weights
    jcfg = jsw.SlidingWindowConfig(**dataclasses.asdict(cfg))
    return np.asarray(jsw.infer_volume(params, vol, jcfg, JAX_CFG, return_binary=False)[0])


# ---------------- host plans against the JAX package's ----------------


@pytest.mark.parametrize("n_sp", [1, 2, 3, 4, 8])
def test_plan_sharding_matches_jax(n_sp):
    """Padded extent, slab, halo and each shard's starts, over a grid of
    (z, roi, stride); where JAX's hop check fails the port raises."""
    for z in (16, 24, 50, 61, 64, 70, 96, 192, 257):
        for roi_z, stride in ((16, 8), (16, 16), (16, 5), (32, 16), (96, 48)):
            if roi_z > z:
                continue
            try:
                want = jsi.plan_sharding(z, roi_z, stride, n_sp)
            except AssertionError:
                with pytest.raises(ValueError, match="hops"):
                    plan_sharding(z, roi_z, stride, n_sp)
                continue
            assert plan_sharding(z, roi_z, stride, n_sp) == want


@pytest.mark.parametrize("z,n_sp", [(64, 4), (70, 4), (50, 8), (192, 4)])
def test_per_shard_starts_match_jax(z, n_sp):
    ys, xs = [0, 8, 16], [0, 8, 14]
    shard_z = jsi.plan_sharding(z, 16, 8, n_sp)[3]
    want, valid = jsi._per_shard_starts(shard_z, ys, xs, n_sp)
    got = _per_shard_starts(shard_z, ys, xs)
    assert len(got) == n_sp
    for k in range(n_sp):
        np.testing.assert_array_equal(got[k], want[k][valid[k]])


def test_brain_deal_and_hybrid_mesh_match_jax():
    for n_brains in range(0, 12):
        for n_slices in range(1, 9):
            assert pmesh.assign_brains_to_slices(n_brains, n_slices) == \
                jmesh.assign_brains_to_slices(n_brains, n_slices)
    for n_slices in (None, 1, 2, 3, 4, 8, 64):
        want = jmesh.make_hybrid_mesh(n_slices=n_slices)
        got = pmesh.make_hybrid_mesh(n_slices=n_slices, devices=["cpu"] * 8)
        assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
        subs = pmesh.slice_submeshes(got)
        assert [s.devices.size for s in subs] == [s.devices.size for s in jmesh.slice_submeshes(want)]
        assert all(s.axis_names == ("sp",) for s in subs)


def test_make_mesh_shapes_and_repeated_devices():
    m = make_mesh({"dp": 2, "sp": 4}, devices=["cpu"] * 8)
    assert m.shape == {"dp": 2, "sp": 4} and m.devices.size == 8
    assert m.axis_devices("sp") == [torch.device("cpu")] * 4
    assert make_mesh(devices=["cpu"] * 3).shape == {"sp": 3}
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh({"sp": 4}, devices=["cpu"] * 3)


def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default devices are valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


# ---------------- maybe_initialize_distributed (seven cases) ----------------


@pytest.fixture()
def init_spy(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


def test_no_env_no_init(init_spy):
    assert pmesh.maybe_initialize_distributed(env={}) is False
    assert init_spy == []


def test_single_process_torchrun_no_init(init_spy):
    env = {"WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "RANK": "0"}
    assert pmesh.maybe_initialize_distributed(env=env) is False
    assert init_spy == []


def test_torchrun_launch_auto_init(init_spy):
    env = {"WORLD_SIZE": "4", "RANK": "2", "MASTER_ADDR": "10.0.0.2",
           "MASTER_PORT": "29400"}
    assert pmesh.maybe_initialize_distributed(env=env) is True
    assert init_spy == [{"backend": "gloo", "init_method": "tcp://10.0.0.2:29400",
                         "world_size": 4, "rank": 2}]


def test_already_initialized_is_a_no_op(init_spy, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    env = {"DELIVR_COORDINATOR": "10.0.0.2:8476", "DELIVR_NUM_PROCESSES": "2"}
    assert pmesh.maybe_initialize_distributed(env=env) is False
    assert init_spy == []


def test_disabled_overrides_launch_env(init_spy):
    env = {"DELIVR_DISTRIBUTED": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h0",
           "DELIVR_COORDINATOR": "h0:1"}
    assert pmesh.maybe_initialize_distributed(env=env) is False
    assert init_spy == []


def test_forced_init(init_spy):
    assert pmesh.maybe_initialize_distributed(env={"DELIVR_DISTRIBUTED": "1"}) is True
    assert init_spy == [{"backend": "gloo", "init_method": "env://"}]


def test_explicit_coordinator_args(init_spy):
    env = {
        "DELIVR_COORDINATOR": "10.0.0.2:8476",
        "DELIVR_NUM_PROCESSES": "4",
        "DELIVR_PROCESS_ID": "3",
    }
    assert pmesh.maybe_initialize_distributed(env=env) is True
    assert init_spy == [{"backend": "gloo", "init_method": "tcp://10.0.0.2:8476",
                         "world_size": 4, "rank": 3}]


# ---------------- sharded inference ----------------


@pytest.mark.parametrize("n_sp", [2, 4, 8])
def test_sharded_matches_single_device(weights, n_sp):
    vol = _volume()
    cfg = _cfg()
    model, _ = weights
    got = sharded_infer_volume(_cpu_mesh(n_sp), model, vol, cfg, PORT_CFG).numpy()
    np.testing.assert_allclose(got, _single(weights, vol, cfg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _jax_single(weights, vol, cfg), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("z,n_sp", [
    (70, 4),  # clamped last z start, padded slabs, an empty shard
    (61, 4),  # awkward odd extent
    (50, 8),  # shallow volume on a wide mesh: a shard of the clamped start only
    (70, 2),
])
def test_sharded_matches_single_device_arbitrary_z(weights, z, n_sp):
    vol = _volume(shape=(z, 32, 32), seed=z)
    cfg = _cfg()
    model, _ = weights
    got = sharded_infer_volume(_cpu_mesh(n_sp), model, vol, cfg, PORT_CFG).numpy()
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, _single(weights, vol, cfg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _jax_single(weights, vol, cfg), rtol=1e-4, atol=1e-4)


def test_sharded_tta_flips(weights):
    vol = _volume(seed=1)
    cfg = _cfg(tta=True, tta_noise_std=0.0)
    model, _ = weights
    got = sharded_infer_volume(_cpu_mesh(4), model, vol, cfg, PORT_CFG).numpy()
    np.testing.assert_allclose(got, _single(weights, vol, cfg), rtol=1e-4, atol=1e-4)


def test_sharded_gaussian_importance(weights):
    vol = _volume(shape=(70, 32, 32), seed=2)
    cfg = _cfg(importance="gaussian")
    model, _ = weights
    got = sharded_infer_volume(_cpu_mesh(4), model, vol, cfg, PORT_CFG).numpy()
    np.testing.assert_allclose(got, _single(weights, vol, cfg), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shard_axis", [1, 2])
def test_sharded_along_y_and_x(weights, shard_axis):
    rng = np.random.default_rng(21)
    vol = np.zeros((24, 70, 40), np.uint16)
    vol[:, :40, :20] = (rng.random((24, 40, 20)) * 800).astype(np.uint16)
    cfg = _cfg()
    model, _ = weights
    got = sharded_infer_volume(_cpu_mesh(4), model, vol, cfg, PORT_CFG,
                               shard_axis=shard_axis).numpy()
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, _single(weights, vol, cfg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _jax_single(weights, vol, cfg), rtol=1e-4, atol=1e-4)


def test_sharded_tta_noise_shards_draw_independent_streams(weights):
    """Each shard seeds its own generator: on a z-periodic volume where each
    of two shards owns one identical window (overlap 0: no halo, no spill)
    the noise-free run is exactly symmetric and the noisy run is not."""
    rng = np.random.default_rng(7)
    half = (rng.random((16, 16, 16)) * 900).astype(np.uint16)
    vol = np.concatenate([half, half], axis=0)
    model, _ = weights
    mesh = _cpu_mesh(2)
    clean = sharded_infer_volume(mesh, model, vol, _cfg(overlap=0.0, batch_size=2, tta=True,
                                                         tta_noise_std=0.0), PORT_CFG).numpy()
    np.testing.assert_array_equal(clean[:16], clean[16:])
    noisy = sharded_infer_volume(mesh, model, vol, _cfg(overlap=0.0, batch_size=2, tta=True,
                                                         tta_noise_std=0.5), PORT_CFG).numpy()
    assert np.abs(noisy[:16] - noisy[16:]).max() > 0


def test_sharded_tta_noise_statistical_bound(weights):
    """Noise draws differ from one device's, but a fixed seed repeats
    bit for bit and the result stays within a noise-scale bound of the
    noise-free run."""
    vol = _volume(shape=(32, 32, 32), seed=4)
    model, _ = weights
    mesh = _cpu_mesh(4)
    cfg = _cfg(tta=True, tta_noise_std=1e-3)
    noisy = sharded_infer_volume(mesh, model, vol, cfg, PORT_CFG).numpy()
    again = sharded_infer_volume(mesh, model, vol, cfg, PORT_CFG).numpy()
    np.testing.assert_array_equal(noisy, again)
    clean = sharded_infer_volume(mesh, model, vol, dataclasses.replace(cfg, tta_noise_std=0.0),
                                 PORT_CFG).numpy()
    assert np.abs(noisy - clean).max() < 0.05
    other = sharded_infer_volume(mesh, model, vol, dataclasses.replace(cfg, seed=1),
                                 PORT_CFG).numpy()
    assert np.abs(other - noisy).max() > 0


def test_halo_bytes_and_replicas(weights):
    """(70, 32, 32) on 4 shards: zloc 24, halo 8 (plan above); 3 input
    halos of 8 uint16 planes are pulled and, from the 3 shards with windows,
    8 planes of f32 sums and int32 counts are pushed. One device: the model
    is its own replica; a second device gets a copy."""
    model, _ = weights
    sharded_accumulate.halo_in_bytes = sharded_accumulate.halo_out_bytes = 0
    sharded_accumulate(_cpu_mesh(4), model, _volume(shape=(70, 32, 32)), _cfg(), PORT_CFG)
    plane = 32 * 32
    assert sharded_accumulate.halo_in_bytes == 3 * 8 * plane * 2
    assert sharded_accumulate.halo_out_bytes == 3 * 8 * plane * (4 + 4)
    assert replicate(model, ["cpu"] * 4) == {torch.device("cpu"): model}


def test_volume_smaller_than_roi_raises(weights):
    model, _ = weights
    with pytest.raises(ValueError, match="smaller than the roi"):
        sharded_infer_volume(_cpu_mesh(2), model, _volume(shape=(32, 8, 32)), _cfg(), PORT_CFG)


# ---------------- streaming with mesh= ----------------


def _stream(model, vol, cfg, **kw):
    logits = np.full(vol.shape, np.nan, np.float32)
    bins, _ = st.infer_volume_streaming(model, vol, cfg, PORT_CFG, logits_out=logits, **kw)
    return bins, logits


@pytest.mark.parametrize("n_sp", [2, 4])
def test_sharded_streaming_matches_single_device_streaming(weights, n_sp):
    model, _ = weights
    vol = _volume(shape=(70, 32, 32), seed=9)
    cfg = _cfg(erosion_iters=3)
    want_bin, want_log = _stream(model, vol, cfg, slab_z_starts=2)
    bins, logits = _stream(model, vol, cfg, slab_z_starts=2, mesh=_cpu_mesh(n_sp))
    np.testing.assert_allclose(logits, want_log, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(bins, want_bin)


def test_sharded_streaming_resume_bit_identical(weights, tmp_path):
    """A resume from slab 2 under the mesh gives the uninterrupted mesh
    run's bits, TTA noise included; the sidecar records the shard count, so
    a single-device sidecar is no resume point for a mesh run."""
    model, _ = weights
    vol = _volume(shape=(72, 32, 32), seed=3)
    cfg = _cfg(tta=True, tta_noise_std=0.3)
    mesh = _cpu_mesh(4)
    full_bin, full_log = _stream(model, vol, cfg, slab_z_starts=2, mesh=mesh)
    sig = st.resume_signature(cfg, vol.shape, vol.shape, 2, 4, spatial_shards=4)
    assert sig != st.resume_signature(cfg, vol.shape, vol.shape, 2, 4)
    state = str(tmp_path / "resume.json")
    with open(state, "w") as f:
        json.dump({"sig": sig, "next_slab": 2, "finalized": 32}, f)
    res_log, res_bin = full_log.copy(), full_bin.copy()
    res_log[32:], res_bin[32:] = -1, 255
    st.infer_volume_streaming(model, vol, cfg, PORT_CFG, slab_z_starts=2, binary_out=res_bin,
                              logits_out=res_log, resume_state_path=state, mesh=mesh)
    assert not os.path.exists(state)
    np.testing.assert_array_equal(res_log, full_log)
    np.testing.assert_array_equal(res_bin, full_bin)


@pytest.mark.slow  # the JAX package's sharded engine compiles a shard_map
def test_matches_the_jax_sharded_engine(weights):
    from delivr_cfos_tpu.parallel import make_mesh as jax_make_mesh

    model, params = weights
    vol = _volume(shape=(70, 32, 32), seed=70)
    cfg = _cfg()
    want = np.asarray(jsi.sharded_infer_volume(
        jax_make_mesh({"sp": 4}), params, vol,
        jsw.SlidingWindowConfig(**dataclasses.asdict(cfg)), JAX_CFG))
    got = sharded_infer_volume(_cpu_mesh(4), model, vol, cfg, PORT_CFG).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
