"""Random-forest pixel classifier — in-framework replacement for Ilastik.

The port's counterpart of ``delivr_cfos_tpu/models/pixel_classifier.py``.
The reference shells out to a prebuilt Ilastik install with a shipped .ilp
project (reference: downsample/downsample_and_mask.py:75-93). This module
provides the equivalent capability:

- a trainer (``fit_pixel_classifier``) that learns a random forest from
  sparse voxel labels (scribbles) on 8-bit downsampled stacks: the feature
  bank of ops/features.py on the device, the CART fit on the host (numpy,
  the JAX package's code, so a seed gives the same trees given the same
  features);
- a device evaluator: trees are stored in an oblivious (perfect-tree) array
  layout, so classification is ``depth`` gather steps over all voxels of a
  z-chunk, one tree after another — no per-voxel control flow;
- the .npz model format (``save_model``/``load_model``), which both packages
  read and write alike, and .ilp projects through models/ilastik_import.py.

Given the same features, both forest layouts give the JAX package's
probabilities bit for bit: trees add in index order in float32, and the sum
is scaled once by the float32 reciprocal of the tree count (what XLA makes
of the JAX package's ``acc / n_trees``).

``predict_mask_probabilities`` returns uint8 0..255 probabilities, the value
convention of the reference's Ilastik output ("Saved masks have
probabilities 0 - 255", downsample_and_mask.py:267), which stage 1 binarizes
at 125. When no trained model exists at the configured path, an Otsu
threshold fallback produces {0, 255} probabilities so the pipeline stays
runnable end-to-end.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from delivr_cfos_tpu_torch.ops.features import (
    DEFAULT_SIGMAS,
    feature_bank,
    ilastik_feature_bank,
)
from delivr_cfos_tpu_torch.ops.resample import reciprocal_f32
from delivr_cfos_tpu_torch.utils.device import StepSeconds, resolve_device, upload


# --------------------------------------------------------------------------
# forest training (host, numpy CART)
# --------------------------------------------------------------------------


def _gini_split(xf: np.ndarray, y: np.ndarray):
    """Best threshold for one feature by Gini impurity; returns (gain, thr)."""
    order = np.argsort(xf, kind="stable")
    xs, ys = xf[order], y[order]
    n = ys.shape[0]
    total_pos = ys.sum()
    left_pos = np.cumsum(ys)[:-1]
    left_n = np.arange(1, n)
    right_pos = total_pos - left_pos
    right_n = n - left_n
    # skip splits between equal feature values
    valid = xs[1:] != xs[:-1]
    if not valid.any():
        return 0.0, None
    p_l = left_pos / left_n
    p_r = right_pos / right_n
    gini = (left_n * 2 * p_l * (1 - p_l) + right_n * 2 * p_r * (1 - p_r)) / n
    parent_p = total_pos / n
    parent_gini = 2 * parent_p * (1 - parent_p)
    gains = np.where(valid, parent_gini - gini, -1.0)
    best = int(np.argmax(gains))
    if gains[best] <= 0:
        return 0.0, None
    thr = (xs[best] + xs[best + 1]) / 2.0
    return float(gains[best]), float(thr)


def _fit_tree(X, y, max_depth, min_leaf, rng):
    """CART in perfect-tree array layout: internal nodes 0..2^d−2, leaves
    2^d−1..2^{d+1}−2. Pruned nodes become pass-through (feature −1 → always
    go left), so evaluation always walks exactly ``max_depth`` steps."""
    n_internal = 2**max_depth - 1
    n_leaves = 2**max_depth
    feat = np.full(n_internal, -1, np.int32)
    thr = np.full(n_internal, np.inf, np.float32)
    leaf = np.zeros(n_leaves, np.float32)
    n_feat = X.shape[1]
    k = max(int(np.sqrt(n_feat)), 1)

    def grow(node, idx, depth):
        y_node = y[idx]
        p = float(y_node.mean()) if idx.size else 0.0
        if depth == max_depth:
            leaf[node - n_internal] = p
            return
        done = (
            idx.size < 2 * min_leaf
            or p == 0.0
            or p == 1.0
        )
        if not done:
            feats = rng.choice(n_feat, size=k, replace=False)
            best_gain, best_f, best_t = 0.0, None, None
            for f in feats:
                gain, t = _gini_split(X[idx, f], y_node)
                if t is not None and gain > best_gain:
                    best_gain, best_f, best_t = gain, f, t
            done = best_f is None
        if done:
            # pass-through: every descendant leaf gets this node's posterior
            lo = node
            for d in range(depth, max_depth):
                lo = 2 * lo + 1
            hi = lo + 2 ** (max_depth - depth)
            leaf[lo - n_internal : hi - n_internal] = p
            return
        feat[node] = best_f
        thr[node] = best_t
        mask = X[idx, best_f] > best_t
        grow(2 * node + 1, idx[~mask], depth + 1)
        grow(2 * node + 2, idx[mask], depth + 1)

    grow(0, np.arange(X.shape[0]), 0)
    return feat, thr, leaf


def fit_pixel_classifier(
    stacks,
    label_stacks,
    sigmas: tuple = DEFAULT_SIGMAS,
    n_trees: int = 16,
    max_depth: int = 8,
    min_leaf: int = 8,
    max_samples: int = 200_000,
    seed: int = 0,
    *,
    device=None,
) -> dict:
    """Train a forest from (stack, labels) pairs: the feature bank runs on
    ``device`` (None: the card), the fit on the host.

    ``label_stacks`` use the Ilastik scribble convention: 0 = unlabeled,
    1 = foreground (keep), 2 = background/ventricle (mask out).
    Returns the model dict (save with ``save_model``).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    X_parts, y_parts = [], []
    for stack, labels in zip(stacks, label_stacks):
        feats = feature_bank(upload(stack, device), sigmas).cpu().numpy()
        sel = labels > 0
        X_parts.append(feats[sel])
        y_parts.append((labels[sel] == 1).astype(np.float64))
    X = np.concatenate(X_parts, axis=0)
    y = np.concatenate(y_parts, axis=0)
    if X.shape[0] > max_samples:
        keep = rng.choice(X.shape[0], size=max_samples, replace=False)
        X, y = X[keep], y[keep]
    feats_arr, thr_arr, leaf_arr = [], [], []
    for t in range(n_trees):
        boot = rng.integers(0, X.shape[0], size=X.shape[0])
        f, th, lf = _fit_tree(X[boot], y[boot], max_depth, min_leaf, rng)
        feats_arr.append(f)
        thr_arr.append(th)
        leaf_arr.append(lf)
    return {
        "feature": np.stack(feats_arr),  # (T, 2^d − 1)
        "threshold": np.stack(thr_arr),
        "leaf": np.stack(leaf_arr),  # (T, 2^d)
        "max_depth": np.int32(max_depth),
        "sigmas": np.asarray(sigmas, np.float64),
    }


def save_model(path: str, model: dict) -> None:
    np.savez_compressed(path, **model)


def load_model(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------------------
# forest evaluation (device)
# --------------------------------------------------------------------------


def _forest_eval(feats2d, feature, threshold, leaf, *, max_depth):
    """feats2d (P, F) → probability (P,), oblivious layout. Walks every tree
    exactly ``max_depth`` steps; per step one gather per tree. ``feature``
    is int64 on the device of ``feats2d``."""
    n_trees, n_internal = feature.shape
    p = feats2d.shape[0]
    acc = torch.zeros(p, dtype=torch.float32, device=feats2d.device)
    for t in range(n_trees):
        node = torch.zeros(p, dtype=torch.int64, device=feats2d.device)
        for _ in range(max_depth):
            f = feature[t][node]
            th = threshold[t][node]
            # pruned nodes: f == −1 → compare feature 0 vs +inf → go left
            val = torch.gather(feats2d, 1, torch.clamp(f, min=0)[:, None])[:, 0]
            go_right = (val > th) & (f >= 0)
            node = 2 * node + 1 + go_right
        acc = acc + leaf[t][node - n_internal]
    return acc * reciprocal_f32(n_trees)


def _forest_eval_pointer(feats2d, feature, threshold, left, right, value, *,
                         max_steps):
    """Pointer-layout forest (imported Ilastik/sklearn trees — arbitrary
    topology, leaves self-loop): feats2d (P, F) → probability (P,).
    Convention: go right iff feature value >= threshold. ``feature``,
    ``left`` and ``right`` are int64."""
    n_trees = feature.shape[0]
    p = feats2d.shape[0]
    acc = torch.zeros(p, dtype=torch.float32, device=feats2d.device)
    for t in range(n_trees):
        node = torch.zeros(p, dtype=torch.int64, device=feats2d.device)
        for _ in range(max_steps):
            f = feature[t][node]
            th = threshold[t][node]
            val = torch.gather(feats2d, 1, torch.clamp(f, min=0)[:, None])[:, 0]
            nxt = torch.where(val >= th, right[t][node], left[t][node])
            node = torch.where(f < 0, node, nxt)
        acc = acc + value[t][node]
    return acc * reciprocal_f32(n_trees)


def _model_features(chunk: torch.Tensor, model: dict) -> torch.Tensor:
    """Feature stack for a z-chunk, honoring the model's feature definition
    (trained-in-framework sigma bank, or an imported .ilp feature spec)."""
    if "feature_spec" in model:
        raw = model["feature_spec"]
        raw = bytes(raw) if not isinstance(raw, bytes) else raw
        spec = tuple((fid, float(s)) for fid, s in json.loads(raw.decode()))
        return ilastik_feature_bank(chunk, spec)
    sigmas = tuple(float(s) for s in model["sigmas"])
    return feature_bank(chunk, sigmas)


def predict_probabilities(stack: np.ndarray, model: dict, chunk_z: int = 32, *,
                          device=None, timer: StepSeconds | None = None) -> np.ndarray:
    """(Z, Y, X) 8-bit stack → float32 foreground probability (Z, Y, X).

    The device holds one z-chunk (with its halo) and its features at a time.
    Accepts both model layouts: the framework's oblivious perfect-tree
    forest (.npz from fit_pixel_classifier) and the pointer-tree forest
    imported from an Ilastik .ilp (models/ilastik_import.py). ``timer``
    gathers the seconds of the "features" and "forest" steps. ``device``
    None means the card."""
    device = resolve_device(device)
    if timer is None:
        timer = StepSeconds(device)

    def on_device(key, dtype):
        return torch.as_tensor(np.asarray(model[key]), dtype=dtype, device=device)

    pointer = "left" in model
    max_depth = int(model["max_depth"])
    feature = on_device("feature", torch.int64)
    threshold = on_device("threshold", torch.float32)
    if pointer:
        left = on_device("left", torch.int64)
        right = on_device("right", torch.int64)
        value = on_device("value", torch.float32)
    else:
        leaf = on_device("leaf", torch.float32)
    out = np.empty(stack.shape, np.float32)
    pad = 16  # feature-bank halo so chunk borders match the global filters
    for z0 in range(0, stack.shape[0], chunk_z):
        z1 = min(z0 + chunk_z, stack.shape[0])
        s0, s1 = max(z0 - pad, 0), min(z1 + pad, stack.shape[0])
        with timer.step("features"):
            feats = _model_features(upload(stack[s0:s1], device), model)
            flat = feats[z0 - s0 : z1 - s0].reshape(-1, feats.shape[-1])
        with timer.step("forest"):
            if pointer:
                probs = _forest_eval_pointer(flat, feature, threshold, left, right,
                                             value, max_steps=max_depth)
            else:
                probs = _forest_eval(flat, feature, threshold, leaf,
                                     max_depth=max_depth)
            out[z0:z1] = probs.reshape(z1 - z0, *stack.shape[1:]).cpu().numpy()
        del feats, flat
    return out


def _otsu_threshold(stack: np.ndarray) -> int:
    hist = np.bincount(stack.ravel().astype(np.int64), minlength=256)[:256]
    total = hist.sum()
    best_t, best_var = 0, -1.0
    w0 = 0.0
    sum0 = 0.0
    sum_all = float((np.arange(256) * hist).sum())
    for t in range(256):
        w0 += hist[t]
        if w0 == 0 or w0 == total:
            continue
        sum0 += t * hist[t]
        m0 = sum0 / w0
        m1 = (sum_all - sum0) / (total - w0)
        var = w0 * (total - w0) * (m0 - m1) ** 2
        if var > best_var:
            best_var, best_t = var, t
    return best_t


def predict_mask_probabilities(stack_8bit: np.ndarray, model_path: str, *,
                               device=None, timer: StepSeconds | None = None) -> np.ndarray:
    """uint8 0..255 probabilities for the stage-1 mask (binarized ≥ 125
    downstream, reference: downsample_and_mask.py:268-269).

    Uses the trained forest at ``model_path`` when present — either the
    framework's .npz or an Ilastik .ilp project imported on the fly
    (models/ilastik_import.py, the reference's own model format,
    config.json:6) — evaluated on ``device`` (None: the card); otherwise an Otsu-threshold
    fallback on the host so unconfigured runs still produce a brain mask."""
    model = None
    if model_path and os.path.exists(model_path):
        if model_path.endswith(".ilp"):
            from delivr_cfos_tpu_torch.models.ilastik_import import load_ilp

            model = load_ilp(model_path)
        elif model_path.endswith(".npz"):
            model = load_model(model_path)
    if model is not None:
        probs = predict_probabilities(stack_8bit, model, device=device, timer=timer)
        return np.clip(probs * 255.0, 0, 255).astype(np.uint8)
    t = _otsu_threshold(stack_8bit)
    return np.where(stack_8bit > t, 255, 0).astype(np.uint8)
