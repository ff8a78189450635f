"""The port's .ilp import (models/ilastik_import.py) and its evaluation:
tests/test_ilastik_import.py's checks on the port, and the port's model
dict against the JAX package's for the same files.

The fixtures build .ilp files in the documented layout, as
tests/test_ilastik_import.py does. The imported dicts must be equal; the
probabilities are held to the same bounds as there (atol 1e-5 against an
independent evaluator), and the uint8 mask to the port's own probabilities
exactly. Skips without h5py (install nothing).
"""

import json
import pickle

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from delivr_cfos_tpu.models.ilastik_import import load_ilp as jax_load_ilp
from delivr_cfos_tpu_torch.models.ilastik_import import load_ilp
from delivr_cfos_tpu_torch.models.pixel_classifier import (
    _forest_eval_pointer,
    predict_mask_probabilities,
    predict_probabilities,
)
from delivr_cfos_tpu_torch.ops.features import ilastik_feature_bank
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LEAF = 0x40000000


def _write_feature_selections(f, ids, scales, sel):
    fs = f.create_group("FeatureSelections")
    fs.create_dataset("FeatureIds", data=np.array([i.encode() for i in ids]))
    fs.create_dataset("Scales", data=np.asarray(scales, np.float64))
    fs.create_dataset("SelectionMatrix", data=np.asarray(sel, bool))


def _vigra_tree_bytes(splits, leaves, n_columns, n_classes):
    """Encode a tree in the vigra topology/parameters layout.

    ``splits``: {addr: (col, thr, child0_addr, child1_addr)};
    ``leaves``: {addr: probs list}. Node addresses must start at 2.
    Returns (topology int32[], parameters float64[])."""
    size = max(
        [a + 5 for a in splits] + [a + 2 for a in leaves]
    )
    topo = np.zeros(size, np.int32)
    topo[0] = n_columns
    topo[1] = n_classes
    params: list[float] = []
    for addr, (col, thr, c0, c1) in splits.items():
        paddr = len(params)
        params += [1.0, thr]  # weight, threshold
        topo[addr] = 0  # i_ThresholdNode
        topo[addr + 1] = paddr
        topo[addr + 2] = c0
        topo[addr + 3] = c1
        topo[addr + 4] = col
    for addr, probs in leaves.items():
        paddr = len(params)
        params += [1.0] + list(probs)
        topo[addr] = LEAF  # e_ConstProbNode
        topo[addr + 1] = paddr
    return topo, np.asarray(params, np.float64)


@pytest.fixture
def vigra_ilp(tmp_path):
    """Two-tree forest over 2 features, hand-specified topology."""
    path = str(tmp_path / "proj.ilp")
    with h5py.File(path, "w") as f:
        _write_feature_selections(
            f,
            ["GaussianSmoothing", "GaussianGradientMagnitude"],
            [0.7, 1.6],
            [[True, False], [False, True]],
        )
        pc = f.create_group("PixelClassification")
        pc.create_dataset(
            "LabelNames", data=np.array([b"Structure", b"Background"])
        )
        forests = pc.create_group("ClassifierForests")
        f0 = forests.create_group("Forest0000")
        # tree 0: root splits feature 0 at 10.0; left → P(fg)=0.9,
        # right subtree splits feature 1 at 5.0
        t0, p0 = _vigra_tree_bytes(
            splits={2: (0, 10.0, 7, 9), 9: (1, 5.0, 14, 16)},
            leaves={7: [0.9, 0.1], 14: [0.6, 0.4], 16: [0.2, 0.8]},
            n_columns=2,
            n_classes=2,
        )
        g = f0.create_group("Tree_0")
        g.create_dataset("topology", data=t0)
        g.create_dataset("parameters", data=p0)
        # tree 1: pure leaf forest member splitting feature 1 at 0.0
        t1, p1 = _vigra_tree_bytes(
            splits={2: (1, 0.0, 7, 9)},
            leaves={7: [1.0, 0.0], 9: [0.3, 0.7]},
            n_columns=2,
            n_classes=2,
        )
        g = f0.create_group("Tree_1")
        g.create_dataset("topology", data=t1)
        g.create_dataset("parameters", data=p1)
    return path


def _eval_reference(feats):
    """Pure-python walk of the vigra_ilp fixture forest (class 0 prob)."""
    out = np.zeros(feats.shape[0])
    for i, (f0, f1) in enumerate(feats):
        p0 = 0.9 if f0 < 10.0 else (0.6 if f1 < 5.0 else 0.2)
        p1 = 1.0 if f1 < 0.0 else 0.3
        out[i] = (p0 + p1) / 2
    return out


def _assert_same_model(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert np.asarray(ours[k]).dtype == np.asarray(theirs[k]).dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_vigra_ilp_import_and_eval(vigra_ilp):
    model = load_ilp(vigra_ilp)
    _assert_same_model(model, jax_load_ilp(vigra_ilp))
    assert bytes(model["kind"]) == b"pointer"
    spec = json.loads(bytes(model["feature_spec"]).decode())
    assert spec == [["GaussianSmoothing", 0.7], ["GaussianGradientMagnitude", 1.6]]
    assert model["feature"].shape[0] == 2  # two trees
    assert int(model["max_depth"]) == 2

    # classify a synthetic stack and compare against the hand evaluator
    rng = np.random.default_rng(0)
    stack = (rng.random((4, 16, 16)) * 40).astype(np.uint8)
    probs = predict_probabilities(stack, model, device="cpu")
    feats = ilastik_feature_bank(
        torch.from_numpy(stack.astype(np.float32)),
        (("GaussianSmoothing", 0.7), ("GaussianGradientMagnitude", 1.6)),
    ).numpy().reshape(-1, 2)
    expected = _eval_reference(feats).reshape(stack.shape)
    np.testing.assert_allclose(probs, expected, atol=1e-5)


def test_vigra_threshold_edge_goes_left(vigra_ilp):
    """vigra routes x < thr to child0; exactly-equal goes right."""
    model = load_ilp(vigra_ilp)
    feats = torch.tensor([[10.0, 5.0]])  # both exactly at thr
    p = _forest_eval_pointer(
        feats,
        torch.from_numpy(model["feature"]).long(),
        torch.from_numpy(model["threshold"]),
        torch.from_numpy(model["left"]).long(),
        torch.from_numpy(model["right"]).long(),
        torch.from_numpy(model["value"]),
        max_steps=int(model["max_depth"]),
    )
    # tree0: f0=10 ≥ 10 → right subtree; f1=5 ≥ 5 → right leaf 0.2
    # tree1: f1=5 ≥ 0 → right leaf 0.3
    np.testing.assert_allclose(np.asarray(p), [(0.2 + 0.3) / 2], atol=1e-6)


def test_sklearn_pickle_ilp_roundtrip(tmp_path):
    sklearn = pytest.importorskip("sklearn")
    from sklearn.ensemble import RandomForestClassifier

    spec = (("GaussianSmoothing", 1.0), ("LaplacianOfGaussian", 1.0))
    rng = np.random.default_rng(1)
    stack = (rng.random((6, 12, 12)) * 255).astype(np.uint8)
    stack[:, 4:8] = 250  # structure
    feats = ilastik_feature_bank(
        torch.from_numpy(stack.astype(np.float32)), spec
    ).numpy().reshape(-1, 2)
    y = (stack > 180).astype(int).ravel()
    clf = RandomForestClassifier(n_estimators=5, max_depth=4, random_state=0)
    clf.fit(feats.astype(np.float32), y)

    path = str(tmp_path / "sk.ilp")
    with h5py.File(path, "w") as f:
        _write_feature_selections(
            f,
            ["GaussianSmoothing", "LaplacianOfGaussian"],
            [1.0],
            [[True], [True]],
        )
        pc = f.create_group("PixelClassification")
        pc.create_dataset("LabelNames", data=np.array([b"fg", b"bg"]))
        forests = pc.create_group("ClassifierForests")
        blob = np.frombuffer(pickle.dumps(clf), np.uint8)
        forests.create_dataset("Forest0000", data=blob)

    model = load_ilp(path, class_index=1)  # P(label 1) = clf class 1
    _assert_same_model(model, jax_load_ilp(path, class_index=1))
    probs = predict_probabilities(stack, model, device="cpu")
    expected = clf.predict_proba(feats.astype(np.float32))[:, 1].reshape(
        stack.shape
    )
    np.testing.assert_allclose(probs, expected, atol=1e-5)


def test_predict_mask_probabilities_accepts_ilp(vigra_ilp):
    rng = np.random.default_rng(2)
    stack = (rng.random((3, 12, 12)) * 30).astype(np.uint8)
    out = predict_mask_probabilities(stack, vigra_ilp, device="cpu")
    assert out.dtype == np.uint8
    assert out.shape == stack.shape
    expected = np.clip(
        predict_probabilities(stack, load_ilp(vigra_ilp), device="cpu") * 255.0, 0, 255
    ).astype(np.uint8)
    np.testing.assert_array_equal(out, expected)
