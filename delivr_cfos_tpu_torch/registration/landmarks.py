"""Landmark-constrained global registration.

The port's counterpart of ``delivr_cfos_tpu/registration/landmarks.py``:
the marker reader and the least-squares solve are its numpy copies;
``register_affine_landmarks`` refines through the port's ``register_affine``.

The reference's ``-p a`` mBrainAligner mode registers hemispheres by
landmark correspondence: when ``landmarks_hemisphere`` is set it passes a
marker file of manually placed brain landmarks to ``global_registration``
(reference: automate_mBrainaligner.py:40-56, config.json
``landmarks_hemisphere``). The in-framework equivalent solves the affine
in closed form from the correspondences (least squares, optionally
trimmed for outliers) and can then refine it with the NCC optimizer.

Marker files are Vaa3D ``.marker`` CSV (``x,y,z,radius,shape,name,...``
with ``#`` comment lines, 1-based coordinates) or plain CSV with x,y,z
columns.
"""

from __future__ import annotations

import numpy as np

from delivr_cfos_tpu_torch.registration.affine import register_affine


def read_marker_file(path: str, one_based: bool | None = None) -> np.ndarray:
    """Read landmark coordinates → (N, 3) float32 in (z, y, x) voxel order.

    Vaa3D ``.marker`` files are ``x,y,z,...`` with ``#`` comments and
    1-based coordinates (converted to 0-based unless ``one_based=False``).
    Plain ``.csv`` files may carry an ``x,y,z`` (or ``z,y,x``) header and
    are taken as 0-based unless ``one_based=True``.
    """
    is_marker = path.endswith(".marker")
    if one_based is None:
        one_based = is_marker
    rows = []
    order = "xyz"
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.replace("\t", ",").split(",")]
            try:
                vals = [float(parts[0]), float(parts[1]), float(parts[2])]
            except (ValueError, IndexError):
                # header line: detect column order
                low = [p.lower() for p in parts[:3]]
                if low[:3] == ["z", "y", "x"]:
                    order = "zyx"
                continue
            rows.append(vals)
    pts = np.asarray(rows, np.float32)
    if pts.size == 0:
        return np.zeros((0, 3), np.float32)
    if order == "xyz":
        pts = pts[:, ::-1]  # → (z, y, x)
    if one_based:
        pts = pts - 1.0
    return pts


def affine_from_landmarks(
    src_zyx: np.ndarray,
    dst_zyx: np.ndarray,
    trim_fraction: float = 0.0,
    trim_rounds: int = 3,
) -> np.ndarray:
    """Least-squares (3, 4) affine mapping src → dst voxel coordinates.

    ``trim_fraction`` > 0 makes the solve robust: after each round the
    worst-residual fraction of correspondences is dropped and the affine
    re-solved (a deterministic stand-in for the reference tool's RANSAC
    component; reference global_registration ``-p r+f+n`` / ``-p a``).
    Needs ≥ 4 non-coplanar correspondences.
    """
    src = np.asarray(src_zyx, np.float64)
    dst = np.asarray(dst_zyx, np.float64)
    assert src.shape == dst.shape and src.shape[0] >= 4, "need ≥4 landmark pairs"
    keep = np.ones(src.shape[0], bool)
    A = None
    rounds = trim_rounds if trim_fraction > 0 else 1
    for _ in range(rounds):
        s = np.concatenate([src[keep], np.ones((keep.sum(), 1))], axis=1)
        sol, *_ = np.linalg.lstsq(s, dst[keep], rcond=None)
        A = sol.T  # (3, 4)
        if trim_fraction <= 0:
            break
        res = np.linalg.norm(
            (np.concatenate([src, np.ones((src.shape[0], 1))], axis=1) @ sol)
            - dst,
            axis=1,
        )
        n_keep = max(4, int(np.ceil(src.shape[0] * (1 - trim_fraction))))
        thresh = np.partition(res, n_keep - 1)[n_keep - 1]
        keep = res <= thresh
    return A.astype(np.float32)


def register_affine_landmarks(
    fixed: np.ndarray,
    moving: np.ndarray | None,
    src_zyx: np.ndarray,
    dst_zyx: np.ndarray,
    trim_fraction: float = 0.1,
    refine: bool = True,
    device=None,
    timer=None,
):
    """Landmark LSQ affine, optionally refined with the masked-NCC
    optimizer when an intensity template is available.

    Returns ((3, 4) affine fixed→moving, ncc or None). The refinement runs
    on ``device`` (None: the card).
    """
    aff = affine_from_landmarks(src_zyx, dst_zyx, trim_fraction=trim_fraction)
    if moving is None or not refine:
        return aff, None
    return register_affine(
        fixed, moving, levels=(2, 1), iters=(120, 60), lrs=(0.005, 0.002),
        init=aff, device=device, timer=timer,
    )
