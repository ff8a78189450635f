"""Import Ilastik pixel-classification projects (.ilp) into the framework.

The reference's mask stage is defined by a trained Ilastik project
(reference: downsample/downsample_and_mask.py:75-93; config.json:6 points at
``models/random_forest_weights.ilp``). A lab migrating from DELiVR brings
that .ilp; this module converts it to the framework's forest model so
``predict_mask_probabilities`` evaluates it on device without an Ilastik
install.

An .ilp is an HDF5 file. The parts we read:

  /FeatureSelections/FeatureIds         bytes[] — feature names
  /FeatureSelections/Scales             float[] — sigma set
  /FeatureSelections/SelectionMatrix    bool (n_features, n_scales)
  /PixelClassification/LabelNames       bytes[] — class names
  /PixelClassification/ClassifierForests/Forest0000..NNNN
      VIGRA RandomForest HDF5 serialization (one group per forest; newer
      lazyflow may instead store a pickled sklearn classifier — both are
      handled).

VIGRA tree layout (vigra/random_forest/rf_nodeproxy.hxx — the layout
assumptions are asserted loudly at import time):
  topology int32[]: [0]=column count, [1]=class count, nodes from index 2.
    node: [addr]=typeID, [addr+1]=parameter address;
    interior threshold node (typeID 0): [addr+2]=child0 addr,
      [addr+3]=child1 addr, [addr+4]=split column;
    leaf: typeID has bit 0x40000000 set.
  parameters float64[]: per node at its parameter address:
    interior: [0]=weight, [1]=threshold  (x[col] < threshold → child0);
    leaf: [0]=weight, [1..n_classes]=per-class probabilities.

The imported model dict uses the pointer-tree layout evaluated by
``models.pixel_classifier._forest_eval_pointer`` (arrays feature /
threshold / left / right / value padded over trees), with the split
convention normalized to "go right iff x >= threshold" (sklearn's
``x <= t`` lefts are converted with nextafter).

This is the port's copy of ``delivr_cfos_tpu/models/ilastik_import.py``
(numpy and h5py only); both packages read the same .ilp into the same model
dict.

NOTE: loading the pickled-sklearn variant executes pickle — only import
.ilp files you trust (the same trust you give Ilastik itself).
"""

from __future__ import annotations

import json

import numpy as np

_LEAF_BIT = 0x40000000


def _decode(arr) -> list:
    out = []
    for v in np.asarray(arr).ravel():
        if isinstance(v, bytes):
            out.append(v.decode("utf-8"))
        else:
            out.append(str(v))
    return out


def read_feature_spec(f) -> list:
    """FeatureSelections → ordered [(feature_id, sigma), ...] (feature ids
    outer, scales inner — the SelectionMatrix row-major order)."""
    fs = f["FeatureSelections"]
    ids = _decode(fs["FeatureIds"][()])
    scales = [float(s) for s in np.asarray(fs["Scales"][()]).ravel()]
    sel = np.asarray(fs["SelectionMatrix"][()], bool)
    if sel.shape != (len(ids), len(scales)):
        raise ValueError(
            f".ilp SelectionMatrix shape {sel.shape} does not match "
            f"{len(ids)} feature ids × {len(scales)} scales"
        )
    spec = []
    for i, fid in enumerate(ids):
        for j, s in enumerate(scales):
            if sel[i, j]:
                spec.append((fid, s))
    if not spec:
        raise ValueError(".ilp has an empty feature selection")
    return spec


def _parse_vigra_tree(topology: np.ndarray, parameters: np.ndarray,
                      n_classes: int):
    """One VIGRA decision tree → (feature, threshold, left, right, probs)
    pointer arrays; probs is (n_nodes, n_classes) with rows meaningful at
    leaves."""
    topo = np.asarray(topology, np.int64).ravel()
    par = np.asarray(parameters, np.float64).ravel()
    if topo.size < 4:
        raise ValueError("vigra tree topology too short")
    # topology[0]=column count, [1]=class count (layout assumption — assert)
    if int(topo[1]) != n_classes:
        raise ValueError(
            f"vigra tree class count {topo[1]} != project classes {n_classes}"
        )
    addr_to_idx: dict[int, int] = {}
    feature, threshold, left, right, probs = [], [], [], [], []

    def visit(addr: int) -> int:
        addr = int(addr)
        if addr in addr_to_idx:
            return addr_to_idx[addr]
        idx = len(feature)
        addr_to_idx[addr] = idx
        type_id = int(topo[addr])
        paddr = int(topo[addr + 1])
        feature.append(-1)
        threshold.append(np.inf)
        left.append(idx)
        right.append(idx)
        probs.append(np.zeros(n_classes))
        if type_id & _LEAF_BIT:
            p = par[paddr + 1 : paddr + 1 + n_classes].copy()
            tot = p.sum()
            probs[idx] = p / tot if tot > 0 else p
        else:
            if type_id != 0:
                raise ValueError(
                    f"unsupported vigra node type {type_id} (only threshold "
                    "nodes and ConstProb leaves are supported)"
                )
            feature[idx] = int(topo[addr + 4])
            # vigra: x[col] < threshold → child0. Our convention:
            # go right iff x >= threshold ⇒ left = child0, right = child1.
            threshold[idx] = float(par[paddr + 1])
            left[idx] = visit(topo[addr + 2])
            right[idx] = visit(topo[addr + 3])
        return idx

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, topo.size + 100))
    try:
        visit(2)
    finally:
        sys.setrecursionlimit(old_limit)
    return (
        np.asarray(feature, np.int32),
        np.asarray(threshold, np.float32),
        np.asarray(left, np.int32),
        np.asarray(right, np.int32),
        np.stack(probs).astype(np.float32),
    )


def _trees_from_vigra_forest(grp, n_classes: int) -> list:
    trees = []
    names = sorted(k for k in grp.keys() if k.startswith("Tree"))
    for name in names:
        t = grp[name]
        if "topology" not in t or "parameters" not in t:
            raise ValueError(
                f"vigra forest tree group {name!r} lacks topology/parameters"
            )
        trees.append(
            _parse_vigra_tree(t["topology"][()], t["parameters"][()], n_classes)
        )
    if not trees:
        raise ValueError("vigra forest group contains no Tree_* groups")
    return trees


def _trees_from_sklearn(clf) -> tuple:
    """sklearn RandomForestClassifier → pointer trees; thresholds are
    nextafter'd so 'x <= t → left' becomes 'x >= t' → right' exactly."""
    trees = []
    n_classes = int(clf.n_classes_)
    for est in clf.estimators_:
        t = est.tree_
        feat = t.feature.astype(np.int32)
        thr = t.threshold.astype(np.float64)
        leaf = t.children_left == -1
        feat = np.where(leaf, -1, feat).astype(np.int32)
        idx = np.arange(feat.shape[0], dtype=np.int32)
        left = np.where(leaf, idx, t.children_left).astype(np.int32)
        right = np.where(leaf, idx, t.children_right).astype(np.int32)
        thr = np.where(
            leaf, np.inf, np.nextafter(thr, np.inf)
        ).astype(np.float32)
        counts = t.value[:, 0, :].astype(np.float64)
        tot = counts.sum(axis=1, keepdims=True)
        probs = np.divide(
            counts, np.maximum(tot, 1e-30), dtype=np.float64
        ).astype(np.float32)
        trees.append((feat, thr, left, right, probs))
    return trees, n_classes


def _pad_trees(trees: list, n_classes: int, class_index: int) -> dict:
    n_max = max(t[0].shape[0] for t in trees)
    T = len(trees)
    feature = np.full((T, n_max), -1, np.int32)
    threshold = np.full((T, n_max), np.inf, np.float32)
    left = np.zeros((T, n_max), np.int32)
    right = np.zeros((T, n_max), np.int32)
    value = np.zeros((T, n_max), np.float32)
    max_depth = 0
    for k, (f, th, le, ri, pr) in enumerate(trees):
        n = f.shape[0]
        feature[k, :n] = f
        threshold[k, :n] = th
        left[k, :n] = le
        right[k, :n] = ri
        left[k, n:] = np.arange(n, n_max)
        right[k, n:] = np.arange(n, n_max)
        value[k, :n] = pr[:, class_index]
        # depth = longest root→leaf path (pointer convergence bound)
        depth = np.zeros(n, np.int32)
        order = np.arange(n)
        for i in order:  # children always appear after parents in our builds
            if f[i] >= 0:
                depth[le[i]] = max(depth[le[i]], depth[i] + 1)
                depth[ri[i]] = max(depth[ri[i]], depth[i] + 1)
        max_depth = max(max_depth, int(depth.max(initial=0)))
    return {
        "kind": np.bytes_(b"pointer"),
        "feature": feature,
        "threshold": threshold,
        "left": left,
        "right": right,
        "value": value,
        "max_depth": np.int32(max_depth),
    }


def load_ilp(path: str, class_index: int = 0) -> dict:
    """Read an Ilastik pixel-classification .ilp → framework model dict
    (compatible with ``pixel_classifier.predict_probabilities``).

    ``class_index``: which label's probability the model outputs (the
    reference project's first label is the structure being masked;
    downsample_and_mask.py binarizes the exported probabilities at 125)."""
    import h5py

    with h5py.File(path, "r") as f:
        spec = read_feature_spec(f)
        pc = f.get("PixelClassification")
        if pc is None:
            raise ValueError(f"{path} has no /PixelClassification group")
        label_names = _decode(pc["LabelNames"][()]) if "LabelNames" in pc else []
        forests = pc.get("ClassifierForests")
        if forests is None:
            raise ValueError(f"{path} has no trained classifier")
        trees = []
        n_classes = len(label_names) or 2
        for key in sorted(forests.keys()):
            item = forests[key]
            if hasattr(item, "keys"):  # vigra forest group
                trees += _trees_from_vigra_forest(item, n_classes)
            else:  # pickled (sklearn-backed lazyflow classifier)
                import pickle

                obj = pickle.loads(bytes(np.asarray(item[()]).tobytes()))
                clf = getattr(obj, "_classifier", obj)
                sk_trees, n_classes = _trees_from_sklearn(clf)
                trees += sk_trees
        if class_index >= n_classes:
            raise ValueError(
                f"class_index {class_index} out of range ({n_classes} classes)"
            )
        model = _pad_trees(trees, n_classes, class_index)
        model["feature_spec"] = np.bytes_(
            json.dumps([[fid, s] for fid, s in spec]).encode()
        )
        model["label_names"] = np.asarray(
            [n.encode() for n in label_names], dtype="S64"
        )
        return model
