"""The port's pixel classifier (models/pixel_classifier.py) against the JAX
package's.

Tolerances:
- both forest layouts, given the same features: probabilities equal bit for
  bit (trees add in index order in float32, then one multiplication by the
  float32 reciprocal of the tree count, as XLA computes ``acc / n_trees``;
  6 trees in the pointer case, where a true division would differ);
- a model fitted and saved by the JAX package, predicted by both packages
  from their own features (which agree to float32 rounding, not bit for
  bit, tests/test_torch_features.py): at most 0.1 % of the voxels may take
  another branch somewhere; the count is printed (0 on these stacks);
- the Otsu fallback and the CART fit given the same features: equal.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from delivr_cfos_tpu.models import pixel_classifier as jpc
from delivr_cfos_tpu.ops.features import ilastik_feature_bank as j_ilastik_bank
from delivr_cfos_tpu_torch.models import pixel_classifier as ppc
from delivr_cfos_tpu_torch.models.ilastik_import import _pad_trees
from delivr_cfos_tpu_torch.ops.features import ilastik_feature_bank
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _brainish(shape, seed):
    """An 8-bit stack: a bright noisy ellipsoid in dim noise, and its mask."""
    rng = np.random.default_rng(seed)
    z, y, x = shape
    st = (rng.random(shape) * 40).astype(np.float32)
    zz, yy, xx = np.ogrid[:z, :y, :x]
    ell = (((zz - z / 2) / (z / 2.2)) ** 2 + ((yy - y / 2) / (y / 2.5)) ** 2
           + ((xx - x / 2) / (x / 2.5)) ** 2) < 1
    st[ell] += 120 + rng.random(int(ell.sum())) * 60
    return st.clip(0, 255).astype(np.uint8), ell


def _scribbles(ell, seed, frac=0.05):
    r = np.random.default_rng(seed).random(ell.shape)
    lab = np.zeros(ell.shape, np.uint8)
    lab[ell & (r < frac)] = 1
    lab[~ell & (r < frac)] = 2
    return lab


@pytest.fixture(scope="module")
def jax_model():
    st, ell = _brainish((24, 40, 36), 0)
    return jpc.fit_pixel_classifier([st], [_scribbles(ell, 1)], n_trees=8,
                                    max_depth=6, max_samples=5000, seed=3)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_oblivious_forest_bit_equal_given_features(jax_model):
    st, _ = _brainish((10, 20, 16), 2)
    feats = np.asarray(jpc.feature_bank(jnp.asarray(st))).reshape(-1, 12)
    m = jax_model
    theirs = np.asarray(jpc._forest_eval(
        jnp.asarray(feats), jnp.asarray(m["feature"]), jnp.asarray(m["threshold"]),
        jnp.asarray(m["leaf"]), max_depth=int(m["max_depth"])))
    ours = ppc._forest_eval(_t(feats), _t(m["feature"], torch.int64), _t(m["threshold"]),
                            _t(m["leaf"]), max_depth=int(m["max_depth"])).numpy()
    assert ours.dtype == np.float32 and 0 < ours.mean() < 1
    np.testing.assert_array_equal(ours, theirs)


def _pointer_forest(feats, n_trees, depth, seed, ties=True):
    """Random pointer trees (arbitrary topology, leaves self-loop) whose
    thresholds are feature values themselves, so ``>=`` ties occur, or
    (``ties`` False) midpoints between two of them."""
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(n_trees):
        feat, thr, left, right, val = [], [], [], [], []

        def grow(d):
            i = len(feat)
            feat.append(-1)
            thr.append(np.inf)
            left.append(i)
            right.append(i)
            val.append(rng.random())
            if d < depth and rng.random() < 0.8:
                f = int(rng.integers(feats.shape[1]))
                feat[i] = f
                a, b = feats[rng.integers(feats.shape[0], size=2), f]
                thr[i] = float(a if ties else (a + b) / 2)
                left[i] = grow(d + 1)
                right[i] = grow(d + 1)
            return i

        grow(0)
        probs = np.stack([np.asarray(val), 1 - np.asarray(val)], axis=1)
        trees.append((np.asarray(feat, np.int32), np.asarray(thr, np.float32),
                      np.asarray(left, np.int32), np.asarray(right, np.int32),
                      probs.astype(np.float32)))
    return _pad_trees(trees, 2, 0)


def test_pointer_forest_bit_equal_given_features():
    st, _ = _brainish((8, 16, 16), 4)
    feats = np.asarray(jpc.feature_bank(jnp.asarray(st))).reshape(-1, 12)
    m = _pointer_forest(feats, n_trees=6, depth=7, seed=5)
    args = [m[k] for k in ("feature", "threshold", "left", "right", "value")]
    theirs = np.asarray(jpc._forest_eval_pointer(
        jnp.asarray(feats), *map(jnp.asarray, args), max_steps=int(m["max_depth"])))
    ours = ppc._forest_eval_pointer(
        _t(feats), _t(args[0], torch.int64), _t(args[1]), _t(args[2], torch.int64),
        _t(args[3], torch.int64), _t(args[4]), max_steps=int(m["max_depth"])).numpy()
    np.testing.assert_array_equal(ours, theirs)


def test_jax_saved_model_predicts_alike(jax_model, tmp_path):
    """A model the JAX package fitted and saved, read by the port's
    ``load_model`` and by the JAX package's, on a stack it was not fitted
    on; the .npz needs no conversion."""
    path = str(tmp_path / "forest.npz")
    jpc.save_model(path, jax_model)
    ours_model = ppc.load_model(path)
    assert sorted(ours_model) == sorted(jax_model)
    st, _ = _brainish((24, 40, 36), 5)
    ours = ppc.predict_probabilities(st, ours_model, chunk_z=8, device="cpu")
    theirs = jpc.predict_probabilities(st, jpc.load_model(path), chunk_z=8)
    differ = int((ours != theirs).sum())
    print(f"voxels whose probability differs: {differ} of {st.size}")
    assert differ <= st.size // 1000
    # through the mask entry point: uint8 0..255
    ours8 = ppc.predict_mask_probabilities(st, path, device="cpu")
    np.testing.assert_array_equal(
        ours8, np.clip(ours * 255.0, 0, 255).astype(np.uint8))
    assert int((ours8 != jpc.predict_mask_probabilities(st, path)).sum()) <= differ


def test_chunked_prediction_equals_one_chunk(jax_model):
    """The 16-plane halo covers the widest filter (radius 14): chunks of 5
    planes give the same bits as one chunk."""
    st, _ = _brainish((23, 20, 18), 6)
    one = ppc.predict_probabilities(st, jax_model, chunk_z=64, device="cpu")
    np.testing.assert_array_equal(
        ppc.predict_probabilities(st, jax_model, chunk_z=5, device="cpu"), one)


def test_otsu_fallback_equals_jax(tmp_path):
    st, _ = _brainish((6, 30, 28), 7)
    for path in ("", str(tmp_path / "missing.npz")):
        ours = ppc.predict_mask_probabilities(st, path, device="cpu")
        np.testing.assert_array_equal(ours, jpc.predict_mask_probabilities(st, path))
        assert set(np.unique(ours)) == {0, 255}
    assert ppc._otsu_threshold(st) == jpc._otsu_threshold(st)


def test_fit_equals_jax_given_the_same_features(monkeypatch):
    """The host CART fit, sampling and bootstrap are the JAX package's: fed
    the JAX package's features, the port fits the same forest."""
    st, ell = _brainish((12, 24, 20), 8)
    lab = _scribbles(ell, 9, frac=0.2)
    theirs = jpc.fit_pixel_classifier([st], [lab], n_trees=4, max_depth=5,
                                      max_samples=800, seed=11)
    monkeypatch.setattr(ppc, "feature_bank", lambda vol, sigmas: torch.tensor(
        np.asarray(jpc.feature_bank(jnp.asarray(vol.numpy()), sigmas))))
    ours = ppc.fit_pixel_classifier([st], [lab], n_trees=4, max_depth=5,
                                    max_samples=800, seed=11, device="cpu")
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert (ours["feature"] >= 0).any()


def test_port_saved_model_reads_in_jax(tmp_path):
    st, ell = _brainish((10, 20, 16), 10)
    model = ppc.fit_pixel_classifier([st], [_scribbles(ell, 12)], n_trees=3,
                                     max_depth=4, max_samples=2000, device="cpu")
    path = str(tmp_path / "port.npz")
    ppc.save_model(path, model)
    back = jpc.load_model(path)
    for k in model:
        np.testing.assert_array_equal(back[k], model[k])


def test_feature_spec_model_uses_the_ilastik_bank():
    """A model carrying an .ilp feature spec is evaluated on that bank: the
    same bits as the port's own bank and forest, and the JAX package's
    probabilities within the tolerance above (thresholds at midpoints
    between feature values, as a fitted forest has them)."""
    st, _ = _brainish((6, 12, 12), 13)
    spec = (("GaussianSmoothing", 0.7), ("LaplacianOfGaussian", 1.6))
    feats = np.asarray(j_ilastik_bank(jnp.asarray(st), spec)).reshape(-1, 2)
    m = _pointer_forest(feats, n_trees=3, depth=4, seed=14, ties=False)
    m["feature_spec"] = np.bytes_(json.dumps([list(s) for s in spec]).encode())
    ours = ppc.predict_probabilities(st, m, device="cpu")
    own = ppc._forest_eval_pointer(
        ilastik_feature_bank(torch.from_numpy(st), spec).reshape(-1, 2),
        *(_t(m[k], torch.int64 if k in ("feature", "left", "right") else None)
          for k in ("feature", "threshold", "left", "right", "value")),
        max_steps=int(m["max_depth"])).numpy().reshape(st.shape)
    np.testing.assert_array_equal(ours, own)
    theirs = jpc.predict_probabilities(st, m)
    assert int((ours != theirs).sum()) <= st.size // 1000


def test_default_device_is_the_card(jax_model, tmp_path):
    """``device`` None means CUDA: where there is none, the forest refuses
    to run on the CPU unasked; the Otsu fallback needs no device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    st, ell = _brainish((4, 8, 8), 15)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ppc.predict_probabilities(st, jax_model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ppc.fit_pixel_classifier([st], [_scribbles(ell, 16)], n_trees=1)
    path = str(tmp_path / "m.npz")
    ppc.save_model(path, jax_model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ppc.predict_mask_probabilities(st, path)
    assert ppc.predict_mask_probabilities(st, "").shape == st.shape
