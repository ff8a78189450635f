"""Native elastix/transformix point-cloud transforms.

The reference's brainrender preprocessing pushes cell point clouds through
the external ``transformix`` binary with elastix ``TransformParameters``
files, twice (intermediate + inverse alignment), parsing the text output
each time (reference: 2021_preprocess_for_brainrender_v13.py:60-167,
ClearMap-derived). This module replaces the binary with a native evaluator
of the transform classes those files contain — ``AffineTransform``,
``EulerTransform``, ``SimilarityTransform``, ``TranslationTransform`` and
``BSplineTransform`` (cubic) — plus readers/writers for the transformix
text formats, so existing elastix registrations remain usable without any
external tool (and the formats stay interoperable with real transformix).

The port's copy of ``delivr_cfos_tpu/analysis/elastix_points.py``, on the host.
"""

from __future__ import annotations

import os
import re

import numpy as np


# --------------------------------------------------------------------------
# transformix point-file I/O (reference :96-121, :60-94)
# --------------------------------------------------------------------------


def write_transformix_points(path: str, points: np.ndarray, kind: str = "point"):
    """Write the ``-def`` input file: 'point'|'index', count, x y z rows in
    %.5e — byte-compatible with the reference's writer (ref :115-121)."""
    points = np.asarray(points, np.float64)
    with open(path, "w") as f:
        f.write(f"{kind}\n")
        f.write(f"{points.shape[0]}\n")
        np.savetxt(f, points, delimiter=" ", newline="\n", fmt="%.5e")
    return path


def parse_transformix_output(path: str, indices: bool = True) -> np.ndarray:
    """Parse transformix ``outputpoints.txt`` — the reference reads the
    OutputIndexFixed field at whitespace columns 22..24 or the OutputPoint
    field at 30..32 (ref parseElastixOutputPoints :60-94)."""
    with open(path) as f:
        lines = f.readlines()
    if not lines:
        return np.zeros((0, 3))
    pts = np.zeros((len(lines), 3))
    col = 22 if indices else 30
    for k, line in enumerate(lines):
        ls = line.split()
        pts[k] = [float(ls[col + i]) for i in range(3)]
    return pts


def write_transformix_output(path: str, in_points: np.ndarray, out_points: np.ndarray):
    """Emit an ``outputpoints.txt`` in transformix's layout so downstream
    consumers (including the reference's parser) can read our results."""
    in_points = np.asarray(in_points, np.float64)
    out_points = np.asarray(out_points, np.float64)
    with open(path, "w") as f:
        for k in range(in_points.shape[0]):
            ip = in_points[k]
            op = out_points[k]
            oi = np.rint(op).astype(int)
            f.write(
                f"Point\t{k}\t; InputIndex = [ {int(round(ip[0]))} {int(round(ip[1]))} {int(round(ip[2]))} ]\t"
                f"; InputPoint = [ {ip[0]:.6f} {ip[1]:.6f} {ip[2]:.6f} ]\t"
                f"; OutputIndexFixed = [ {oi[0]} {oi[1]} {oi[2]} ]\t"
                f"; OutputPoint = [ {op[0]:.6f} {op[1]:.6f} {op[2]:.6f} ]\t"
                f"; Deformation = [ 0.0 0.0 0.0 ]\n"
            )
    return path


# --------------------------------------------------------------------------
# TransformParameters parsing + evaluation
# --------------------------------------------------------------------------

_PARAM_RE = re.compile(r"\(([A-Za-z0-9_]+)((?:\s+[^)]*)?)\)")


def read_transform_parameters(path: str) -> dict:
    """Parse an elastix TransformParameters.N.txt into {key: list | scalar}."""
    out: dict = {}
    with open(path) as f:
        text = f.read()
    for m in _PARAM_RE.finditer(text):
        key = m.group(1)
        raw = m.group(2).strip()
        vals = []
        for tok in raw.split():
            tok = tok.strip('"')
            try:
                vals.append(float(tok))
            except ValueError:
                vals.append(tok)
        out[key] = vals
    return out


def _bspline_w(f):
    f2 = f * f
    f3 = f2 * f
    return np.stack(
        [
            (1 - f) ** 3 / 6.0,
            (3 * f3 - 6 * f2 + 4) / 6.0,
            (-3 * f3 + 3 * f2 + 3 * f + 1) / 6.0,
            f3 / 6.0,
        ]
    )


def _euler_matrix(ax: float, ay: float, az: float, zyx: bool) -> np.ndarray:
    """ITK Euler3DTransform rotation matrix from per-axis angles (radians)."""
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float64)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float64)
    return rz @ ry @ rx if zyx else rz @ rx @ ry


def _versor_matrix(vx: float, vy: float, vz: float) -> np.ndarray:
    """Rotation matrix from an ITK versor's vector part (w ≥ 0 implied)."""
    n2 = vx * vx + vy * vy + vz * vz
    if n2 > 1.0 + 1e-10:
        raise ValueError(f"versor vector norm² {n2} > 1")
    w = np.sqrt(max(1.0 - n2, 0.0))
    x, y, z = vx, vy, vz
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def apply_transform(points_xyz: np.ndarray, params: dict) -> np.ndarray:
    """Evaluate one elastix transform at physical points (N, 3), x-y-z order
    (elastix's native coordinate order)."""
    pts = np.asarray(points_xyz, np.float64)
    tclass = params["Transform"][0]
    p = np.asarray(params["TransformParameters"], np.float64)

    if tclass in ("AffineTransform", "EulerTransform", "SimilarityTransform", "TranslationTransform"):
        if tclass == "AffineTransform":
            A = p[:9].reshape(3, 3)
            t = p[9:12]
        elif tclass == "TranslationTransform":
            A = np.eye(3)
            t = p[:3]
        elif tclass == "EulerTransform":
            # ITK Euler3DTransform: params (θx, θy, θz, tx, ty, tz), radians.
            # Composition order depends on ComputeZYX (elastix default false
            # → R = Rz·Rx·Ry; true → R = Rz·Ry·Rx).
            A = _euler_matrix(
                p[0], p[1], p[2],
                zyx=str(params.get("ComputeZYX", ["false"])[0]).lower()
                == "true",
            )
            t = p[3:6]
        else:  # SimilarityTransform
            # ITK Similarity3DTransform: params (vx, vy, vz, tx, ty, tz, s) —
            # versor vector part, translation, isotropic scale; A = s·R.
            A = float(p[6]) * _versor_matrix(p[0], p[1], p[2])
            t = p[3:6]
        c = np.asarray(
            params.get("CenterOfRotationPoint", [0.0, 0.0, 0.0]), np.float64
        )
        return (pts - c) @ A.T + c + t

    if tclass == "BSplineTransform":
        order = int(params.get("BSplineTransformSplineOrder", [3])[0])
        if order != 3:
            raise NotImplementedError("only cubic B-spline transforms")
        size = np.asarray(params["GridSize"], np.int64)
        origin = np.asarray(params["GridOrigin"], np.float64)
        spacing = np.asarray(params["GridSpacing"], np.float64)
        n = int(np.prod(size))
        # elastix parameter order: all x-coefficients, then y, then z;
        # grid is x-fastest
        coeff = p.reshape(3, n).T.reshape(*size[::-1], 3)  # (z, y, x, 3)
        u = (pts - origin) / spacing  # grid coords, x-y-z
        i = np.floor(u).astype(np.int64) - 1  # cubic support starts at i-1
        f = u - np.floor(u)
        disp = np.zeros_like(pts)
        wz = _bspline_w(f[:, 2])
        wy = _bspline_w(f[:, 1])
        wx = _bspline_w(f[:, 0])
        for a in range(4):
            iz = np.clip(i[:, 2] + a, 0, size[2] - 1)
            for b in range(4):
                iy = np.clip(i[:, 1] + b, 0, size[1] - 1)
                wzy = wz[a] * wy[b]
                for cidx in range(4):
                    ix = np.clip(i[:, 0] + cidx, 0, size[0] - 1)
                    w = wzy * wx[cidx]
                    disp += coeff[iz, iy, ix] * w[:, None]
        return pts + disp

    raise NotImplementedError(f"unsupported elastix transform: {tclass}")


def apply_transform_chain(points_xyz: np.ndarray, param_file: str) -> np.ndarray:
    """Evaluate a TransformParameters file including its
    ``InitialTransformParametersFileName`` chain (initial transforms apply
    first, as transformix does)."""
    chain = []
    path = param_file
    while path and path != "NoInitialTransform":
        params = read_transform_parameters(path)
        chain.append(params)
        nxt = params.get("InitialTransformParametersFileName", ["NoInitialTransform"])[0]
        if isinstance(nxt, float):
            nxt = "NoInitialTransform"
        if nxt != "NoInitialTransform" and not os.path.isabs(nxt):
            nxt = os.path.join(os.path.dirname(path), nxt)
        path = nxt
    pts = np.asarray(points_xyz, np.float64)
    for params in reversed(chain):
        pts = apply_transform(pts, params)
    return pts


def transform_points_native(
    cells_file: str,
    transform_files,
    output_dir: str | None = None,
) -> np.ndarray:
    """The reference's two-step transformix pipeline (ref
    transform_points :96-167), natively: load an (N, 3) ``.npy``/CSV cell
    file, push it through each TransformParameters file in order, and write
    the intermediate text artifacts (points file + outputpoints.txt) with
    the same names/format so downstream tooling is unaffected.
    Returns the transformed (N, 3) array."""
    cells_folder, file_name = os.path.split(cells_file)
    new_folder = output_dir or os.path.join(cells_folder, "Aligned_CCF3")
    os.makedirs(new_folder, exist_ok=True)

    pts = (
        np.load(cells_file)
        if cells_file.endswith(".npy")
        else np.loadtxt(cells_file, delimiter=",", skiprows=1)
    )
    write_transformix_points(
        os.path.join(new_folder, file_name[:-4] + ".txt"), pts
    )
    for tf in transform_files:
        pts_out = apply_transform_chain(pts, tf)
        write_transformix_output(
            os.path.join(new_folder, "outputpoints.txt"), pts, pts_out
        )
        write_transformix_points(
            os.path.join(new_folder, "transformed_points_intermediate.txt"),
            pts_out,
        )
        pts = pts_out
    return pts
