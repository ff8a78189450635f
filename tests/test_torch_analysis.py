"""The port's host analysis tools (delivr_cfos_tpu_torch/analysis/) against
the JAX package's, on the same inputs.

Mirrors tests/test_analysis_extras.py, tests/test_group_stats.py,
tests/test_elastix_points.py and tests/test_brainrender_render.py case by
case: each case runs the JAX function and the port's and keeps the JAX
test's own checks. Both run the same float64 numpy, pandas and scipy code in
the same order, so every float and table is equal to the bit (no tolerance
is needed, and none is used), and every written file is equal byte for
byte: transformix point and output files, brainrender scene JSON and point
clouds, depth-profile CSVs, .npy exports (the depth-profile SVG carries
matplotlib's metadata: both packages write one, or, without matplotlib,
neither).

brainrender, vedo and napari are not installed: the spec, export and
headless paths are held, and the napari loader drives a fake viewer. Its
TIFFs are uncompressed, so the JAX reader takes its Python path and no test
calls ``delivr_cfos_tpu.native.*``."""

import json
import os

import numpy as np
import pandas as pd
import pytest

import delivr_cfos_tpu.analysis.brainrender_export as jbe
import delivr_cfos_tpu.analysis.brainrender_render as jbr
import delivr_cfos_tpu.analysis.depth_profile as jdp
import delivr_cfos_tpu.analysis.elastix_points as jep
import delivr_cfos_tpu.analysis.group_stats as jgs
import delivr_cfos_tpu_torch.analysis.brainrender_export as be
import delivr_cfos_tpu_torch.analysis.brainrender_render as br
import delivr_cfos_tpu_torch.analysis.depth_profile as dp
import delivr_cfos_tpu_torch.analysis.elastix_points as ep
import delivr_cfos_tpu_torch.analysis.group_stats as gs
from delivr_cfos_tpu.utils.io.xlsx import read_xlsx as jax_read_xlsx
from delivr_cfos_tpu.utils.io.xlsx import write_xlsx as jax_write_xlsx
from delivr_cfos_tpu_torch.utils.io.xlsx import read_xlsx, write_xlsx
from test_analysis_extras import REAL_ONTOLOGY  # the JAX test's asset path

CELLS = np.array([[100.0, 200.0, 300.0], [110.0, 210.0, 310.0]])


def _tree(path):
    """{relative path: bytes} of every file under ``path``."""
    out = {}
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _same_frames(a, b):
    pd.testing.assert_frame_equal(a, b, check_exact=True)


# ---------------- depth profile, brainrender export, napari ----------------


def test_depth_profile_monotone_geometry():
    """A solid ball with intensity ∝ depth gives increasing medians; the
    port's table equals JAX's."""
    shape = (40, 40, 40)
    zz, yy, xx = np.indices(shape)
    dist = np.sqrt((zz - 20) ** 2 + (yy - 20) ** 2 + (xx - 20) ** 2)
    vol = np.where(dist < 15, (15 - dist) * 100, 0).astype(np.uint16)
    profile = dp.depth_intensity_profile(vol, spacing=(1, 1, 1))
    _same_frames(profile, jdp.depth_intensity_profile(vol, spacing=(1, 1, 1)))
    med = profile["median_intensity"].dropna().to_numpy()
    assert len(med) >= 10
    assert (np.diff(med) >= 0).mean() > 0.8


def test_calculate_mask_distance_artifacts(tmp_path):
    """Anisotropic spacing: the per-bin CSVs are byte-equal."""
    rng = np.random.default_rng(0)
    vol = np.zeros((20, 20, 20), np.uint16)
    vol[4:16, 4:16, 4:16] = (rng.random((12, 12, 12)) * 500 + 50).astype(np.uint16)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    profile = dp.calculate_mask_distance(vol, port_dir, "sampleA", spacing=(6, 1.62, 1.62))
    ref = jdp.calculate_mask_distance(vol, jax_dir, "sampleA", spacing=(6, 1.62, 1.62))
    _same_frames(profile, ref)
    assert len(profile) > 0
    port_files, jax_files = _tree(port_dir), _tree(jax_dir)
    assert sorted(port_files) == sorted(jax_files)  # the CSV, and the SVG plot
    name = "sampleA_combined_data.csv"
    assert port_files[name] == jax_files[name]


def test_brainrender_transform_formula():
    cells = pd.DataFrame({"x": [528.0, 210.0], "y": [320.0, 120.0], "z": [10.0, 50.0]})
    pts = be.mbrainaligner_atlas_to_ccf_um(cells)
    assert np.array_equal(pts, jbe.mbrainaligner_atlas_to_ccf_um(cells))
    # x' = (528−x−210)·25 ; y' = (320−y+200)·25 ; z' = z·25
    np.testing.assert_array_equal(pts[0], [(-210) * 25, 200 * 25, 250])
    np.testing.assert_array_equal(pts[1], [(528 - 210 - 210) * 25, (320 - 120 + 200) * 25, 1250])


@pytest.mark.parametrize("regions", [["CA1"], None])
def test_export_cells_for_brainrender(tmp_path, regions):
    cells = pd.DataFrame({"x": [10, 20], "y": [30, 40], "z": [50, 60],
                          "acronym": ["CA1", "Isocortex"]})
    csv = str(tmp_path / "cells_m.csv")
    cells.to_csv(csv)
    out = be.export_cells_for_brainrender(csv, str(tmp_path / "port"), "m",
                                          region_acronyms=regions)
    ref = jbe.export_cells_for_brainrender(csv, str(tmp_path / "jax"), "m",
                                           region_acronyms=regions)
    assert os.path.basename(out) == os.path.basename(ref) == "m_cells_um.npy"
    assert open(out, "rb").read() == open(ref, "rb").read()
    pts = np.load(out)
    assert pts.shape == (1 if regions else 2, 3)
    np.testing.assert_array_equal(pts[0], [50 * 25, 30 * 25, 10 * 25])


class _Bar:
    pass


class _Viewer:
    def __init__(self):
        self.layers = []
        self.scale_bar = _Bar()

    def add_image(self, img, **kw):
        self.layers.append((img, kw))


def test_napari_loader_layers(tmp_path):
    """Three additive RGB layers with the reference scale and a visible
    scale bar, the same arrays and arguments as the JAX loader gives."""
    from delivr_cfos_tpu.analysis.napari_loader import load_rgb_output as jax_load
    from delivr_cfos_tpu_torch.analysis.napari_loader import load_rgb_output
    from delivr_cfos_tpu_torch.utils.io.tiff import write_tiff

    rng = np.random.default_rng(3)
    for z in range(4):
        for c in range(3):
            write_tiff(str(tmp_path / f"rgb_C{c:02d}_z{z:04d}.tif"),
                       rng.integers(0, 255, (6, 5), dtype=np.uint8))
    v, jv = _Viewer(), _Viewer()
    assert load_rgb_output(v, str(tmp_path)) is v
    jax_load(jv, str(tmp_path))
    assert len(v.layers) == len(jv.layers) == 3
    for (img, kw), (jimg, jkw) in zip(v.layers, jv.layers):
        assert img.shape == (4, 6, 5) and np.array_equal(img, jimg)
        assert kw == jkw
    assert [kw["colormap"] for _, kw in v.layers] == ["red", "green", "blue"]
    assert all(kw["blending"] == "additive" for _, kw in v.layers)
    assert all(kw["scale"] == [3.0, 4.75, 4.75] for _, kw in v.layers)
    assert vars(v.scale_bar) == vars(jv.scale_bar)
    assert v.scale_bar.visible and v.scale_bar.length == 1000.0


@pytest.mark.skipif(not os.path.exists(REAL_ONTOLOGY), reason="reference asset absent")
def test_parse_real_allen_ontology_asset():
    """The shipped Allen CCFv3 ontology: 1327 structures and the background
    row, the same table as the JAX parser's."""
    from delivr_cfos_tpu.analysis import parse_ontology_xml as jax_parse
    from delivr_cfos_tpu_torch.analysis import parse_ontology_xml

    df = parse_ontology_xml(REAL_ONTOLOGY)
    _same_frames(df, jax_parse(REAL_ONTOLOGY))
    assert len(df) == 1328
    assert df.iloc[0]["acronym"] == "bgr" and df.iloc[1]["id"] == 997


# ---------------- group statistics ----------------


def _toy_region_table():
    """Ontology: background(0) ← nothing; root(997) ← A(1) ← {B(2), C(3)}."""
    rows = [
        (0, "background", "bgr", "None", "None", 0, 0),
        (997, "root", "root", -1, '"root"', 0, 0),
        (1, "Region A", "A", 997, "root", 1, 1),
        (2, "Region B", "B", 1, "A", 2, 2),
        (3, "Region C", "C", 1, "A", 2, 3),
    ]
    df = pd.DataFrame(rows, columns=["id", "name", "acronym", "parent_id",
                                     "parent_acronym", "structure-level", "graph_order"])
    df["m1"] = [0, 0, 1.0, 10.0, 5.0]
    df["m2"] = [0, 0, 2.0, 20.0, 6.0]
    return df


def test_hierarchical_sum_accumulates_up_tree():
    out, overcount = gs.hierarchical_level_sum(_toy_region_table(), ["m1", "m2"])
    j_out, j_over = jgs.hierarchical_level_sum(_toy_region_table(), ["m1", "m2"])
    _same_frames(out, j_out)
    pd.testing.assert_series_equal(overcount, j_over, check_exact=True)
    a = out.loc[out["acronym"] == "A"].iloc[0]
    assert a["m1"] == 16.0 and a["m2"] == 28.0
    assert out.loc[out["acronym"] == "root"].iloc[0]["m1"] == 16.0


def test_benjamini_hochberg_matches_known_values():
    p = np.array([0.01, 0.04, 0.03, 0.005])
    reject, adj = gs.benjamini_hochberg(p, alpha=0.1)
    j_reject, j_adj = jgs.benjamini_hochberg(p, alpha=0.1)
    assert np.array_equal(adj, j_adj) and np.array_equal(reject, j_reject)
    # sorted [.005, .01, .03, .04] → adjusted [.02, .02, .04, .04]
    np.testing.assert_allclose(sorted(adj), [0.02, 0.02, 0.04, 0.04], rtol=1e-15)
    assert reject.all()


def test_benjamini_hochberg_null_case():
    p = np.random.default_rng(0).uniform(0.5, 1.0, 50)
    reject, adj = gs.benjamini_hochberg(p, alpha=0.05)
    j_reject, j_adj = jgs.benjamini_hochberg(p, alpha=0.05)
    assert np.array_equal(adj, j_adj) and np.array_equal(reject, j_reject)
    assert not reject.any() and (adj <= 1).all()


def test_normalize_to_group_mean():
    out = gs.normalize_to_group_mean(_toy_region_table(), ["m1", "m2"], ["m1"])
    _same_frames(out, jgs.normalize_to_group_mean(_toy_region_table(), ["m1", "m2"], ["m1"]))
    assert out.loc[out["acronym"] == "B", "m2"].iloc[0] == 2.0  # 20 / 10


@pytest.mark.parametrize("control", [None, "ctl"])
def test_level_analysis_detects_group_difference(control, capsys):
    """The reference script end to end, with and without normalizing to the
    control group: every table equal, the same lines printed."""
    rng = np.random.default_rng(1)
    df = _toy_region_table().drop(columns=["m1", "m2"])
    g1 = [f"a{i}" for i in range(6)]
    g2 = [f"b{i}" for i in range(6)]
    for c in g1:
        df[c] = [0, 0, 5, 100 + rng.normal(0, 2), 50 + rng.normal(0, 2)]
    for c in g2:
        df[c] = [0, 0, 5, 300 + rng.normal(0, 2), 50 + rng.normal(0, 2)]
    groups = {"ctl": g1, "exp": g2}
    capsys.readouterr()
    res = gs.level_analysis(df, groups, control_group=control, alpha=0.1,
                            drop_levels_from_top=0)
    printed = capsys.readouterr().out
    ref = jgs.level_analysis(df, groups, control_group=control, alpha=0.1,
                             drop_levels_from_top=0)
    assert capsys.readouterr().out == printed
    for key in ("collapsed", "stats"):
        _same_frames(res[key], ref[key])
    pd.testing.assert_series_equal(res["overcount"], ref["overcount"], check_exact=True)
    if control is None:
        b_rows = res["stats"].loc[res["stats"]["acronym"] == "B"]
        assert len(b_rows)
        assert (b_rows["pvals_corrected_ctl_vs_exp"] < 0.05).all()
        assert "found a significant difference" in printed


def test_pairwise_group_tests_with_welch_and_no_levels():
    """Welch's test over three groups (three pairs); a table whose rows all
    hold a zero gives the empty frame in both."""
    rng = np.random.default_rng(7)
    df = _toy_region_table().drop(columns=["m1", "m2"])
    groups = {}
    for gname, mean in (("x", 100), ("y", 130), ("z", 90)):
        groups[gname] = [f"{gname}{i}" for i in range(4)]
        for c in groups[gname]:
            df[c] = [1, 1, 5 + rng.random(), mean + rng.normal(0, 9), 40 + rng.normal(0, 9)]
    kw = dict(equal_var=False, drop_levels_from_top=1, verbose=False)
    _same_frames(gs.pairwise_group_tests(df, groups, **kw),
                 jgs.pairwise_group_tests(df, groups, **kw))
    empty = df.assign(x0=0)
    _same_frames(gs.pairwise_group_tests(empty, groups, **kw),
                 jgs.pairwise_group_tests(empty, groups, **kw))


def test_xlsx_roundtrip_of_region_table(tmp_path):
    """The region table written by the port's xlsx writer reads back equal
    in both readers, and as the JAX-written file reads."""
    df = _toy_region_table()
    p, jp = str(tmp_path / "overview.xlsx"), str(tmp_path / "jax.xlsx")
    write_xlsx(p, {"Sheet1": df})
    jax_write_xlsx(jp, {"Sheet1": df})
    back = read_xlsx(p)
    assert list(back.columns) == list(df.columns) and len(back) == len(df)
    assert back["m1"].tolist() == df["m1"].tolist()
    assert back["name"].tolist() == df["name"].tolist()
    _same_frames(back, jax_read_xlsx(p))
    _same_frames(back, jax_read_xlsx(jp))


# ---------------- elastix / transformix points ----------------


def _write_affine(path, A, t, c, initial="NoInitialTransform"):
    p = list(np.asarray(A).ravel()) + list(t)
    path.write_text(
        '(Transform "AffineTransform")\n'
        "(NumberOfParameters 12)\n"
        f'(TransformParameters {" ".join(f"{v:.9f}" for v in p)})\n'
        f"(CenterOfRotationPoint {c[0]} {c[1]} {c[2]})\n"
        f'(InitialTransformParametersFileName "{initial}")\n'
    )


def _bspline_file(path, size, coeffs, origin=-10.0, spacing=10.0):
    path.write_text(
        '(Transform "BSplineTransform")\n'
        "(BSplineTransformSplineOrder 3)\n"
        f"(GridSize {size[0]} {size[1]} {size[2]})\n"
        f"(GridOrigin {origin} {origin} {origin})\n"
        f"(GridSpacing {spacing} {spacing} {spacing})\n"
        f'(TransformParameters {" ".join(repr(float(v)) for v in coeffs)})\n'
    )


def _both(path, pts):
    """(port, JAX) of apply_transform on the parsed file, after checking
    the two parses are equal."""
    params = ep.read_transform_parameters(str(path))
    assert params == jep.read_transform_parameters(str(path))
    got, want = ep.apply_transform(pts, params), jep.apply_transform(pts, params)
    assert np.array_equal(got, want)
    return got, params


def test_affine_transform_parameters_roundtrip(tmp_path):
    A = np.array([[1.1, 0.02, 0.0], [0.0, 0.9, 0.05], [0.01, 0.0, 1.05]])
    t, c = [3.0, -2.0, 1.0], [10.0, 12.0, 8.0]
    f = tmp_path / "TransformParameters.0.txt"
    _write_affine(f, A, t, c)
    pts = np.random.default_rng(0).uniform(0, 30, (50, 3))
    got, params = _both(f, pts)
    assert params["Transform"] == ["AffineTransform"]
    np.testing.assert_allclose(got, (pts - c) @ A.T + c + t, rtol=0, atol=1e-9)


def test_bspline_transform_zero_coefficients_is_identity(tmp_path):
    size = (6, 5, 4)
    f = tmp_path / "TransformParameters.1.txt"
    _bspline_file(f, size, [0.0] * (3 * int(np.prod(size))))
    pts = np.random.default_rng(1).uniform(0, 20, (20, 3))
    got, _ = _both(f, pts)
    np.testing.assert_allclose(got, pts, rtol=0, atol=1e-12)


def test_bspline_constant_displacement(tmp_path):
    """Constant coefficients shift every point by exactly them (partition
    of unity)."""
    size = (8, 8, 8)
    n = int(np.prod(size))
    f = tmp_path / "TransformParameters.1.txt"
    _bspline_file(f, size, [2.5] * n + [-1.0] * n + [4.0] * n, origin=-20.0)
    pts = np.random.default_rng(2).uniform(0, 25, (30, 3))
    got, _ = _both(f, pts)
    np.testing.assert_allclose(got, pts + [2.5, -1.0, 4.0], rtol=0, atol=1e-9)


def test_bspline_random_coefficients_and_grid_clamp(tmp_path):
    """Random coefficients on a grid whose support the points leave (the
    index clamp at both ends): the port's displacements equal JAX's."""
    size = (7, 6, 5)
    coeffs = np.random.default_rng(8).normal(0, 3, 3 * int(np.prod(size)))
    f = tmp_path / "TransformParameters.1.txt"
    _bspline_file(f, size, coeffs)
    pts = np.random.default_rng(9).uniform(-30, 70, (200, 3))
    got, _ = _both(f, pts)
    assert np.abs(got - pts).max() > 0.1


def _rot(axis, a):
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def test_euler_transform(tmp_path):
    """ITK Euler3DTransform: R = Rz·Rx·Ry, or Rz·Ry·Rx with ComputeZYX."""
    ax, ay, az = 0.3, -0.2, 0.7
    t, c = np.array([4.0, -1.0, 2.0]), np.array([5.0, 6.0, 7.0])
    f = tmp_path / "TransformParameters.0.txt"
    f.write_text(
        '(Transform "EulerTransform")\n'
        "(NumberOfParameters 6)\n"
        f"(TransformParameters {ax} {ay} {az} {t[0]} {t[1]} {t[2]})\n"
        f"(CenterOfRotationPoint {c[0]} {c[1]} {c[2]})\n"
        '(ComputeZYX "false")\n'
    )
    pts = np.random.default_rng(6).uniform(0, 30, (25, 3))
    got, params = _both(f, pts)
    R = _rot("z", az) @ _rot("x", ax) @ _rot("y", ay)
    np.testing.assert_allclose(got, (pts - c) @ R.T + c + t, rtol=0, atol=1e-9)
    params["ComputeZYX"] = ["true"]
    got = ep.apply_transform(pts, params)
    assert np.array_equal(got, jep.apply_transform(pts, params))
    Rzyx = _rot("z", az) @ _rot("y", ay) @ _rot("x", ax)
    np.testing.assert_allclose(got, (pts - c) @ Rzyx.T + c + t, rtol=0, atol=1e-9)


def test_similarity_transform(tmp_path):
    """ITK Similarity3DTransform: (versor xyz, t, scale), A = s·R; a versor
    of norm above 1 raises in both."""
    theta, s = 0.8, 1.25
    versor = [0.0, 0.0, np.sin(theta / 2)]
    t, c = np.array([1.0, 2.0, 3.0]), np.array([10.0, 0.0, -5.0])
    f = tmp_path / "TransformParameters.0.txt"
    f.write_text(
        '(Transform "SimilarityTransform")\n'
        "(NumberOfParameters 7)\n"
        f"(TransformParameters {versor[0]} {versor[1]} {versor[2]} "
        f"{t[0]} {t[1]} {t[2]} {s})\n"
        f"(CenterOfRotationPoint {c[0]} {c[1]} {c[2]})\n"
    )
    pts = np.random.default_rng(7).uniform(-20, 20, (25, 3))
    got, params = _both(f, pts)
    np.testing.assert_allclose(got, (pts - c) @ (s * _rot("z", theta)).T + c + t,
                               rtol=0, atol=1e-9)
    params["TransformParameters"] = [0.9, 0.5, 0.0, 0.0, 0.0, 0.0, 1.0]
    for module in (ep, jep):
        with pytest.raises(ValueError, match="versor"):
            module.apply_transform(pts, params)


def test_translation_and_unsupported_transforms(tmp_path):
    f = tmp_path / "TransformParameters.0.txt"
    f.write_text('(Transform "TranslationTransform")\n(TransformParameters 1.5 -2 0.25)\n')
    pts = np.random.default_rng(10).uniform(0, 9, (5, 3))
    got, params = _both(f, pts)
    np.testing.assert_array_equal(got, pts + [1.5, -2.0, 0.25])
    for module in (ep, jep):
        with pytest.raises(NotImplementedError):
            module.apply_transform(pts, dict(params, Transform=["SplineKernelTransform"]))
        with pytest.raises(NotImplementedError):
            module.apply_transform(pts, {"Transform": ["BSplineTransform"],
                                         "TransformParameters": [],
                                         "BSplineTransformSplineOrder": [1]})


def test_transform_chain_applies_initial_first(tmp_path):
    """An initial transform named by an absolute and by a relative path."""
    f0 = tmp_path / "TransformParameters.0.txt"
    _write_affine(f0, np.diag([2.0, 2.0, 2.0]), [0, 0, 0], [0, 0, 0])
    pts = np.array([[1.0, 2.0, 3.0]])
    for initial in (str(f0), "TransformParameters.0.txt"):
        f1 = tmp_path / "TransformParameters.1.txt"
        _write_affine(f1, np.eye(3), [5, 5, 5], [0, 0, 0], initial=initial)
        got = ep.apply_transform_chain(pts, str(f1))
        assert np.array_equal(got, jep.apply_transform_chain(pts, str(f1)))
        np.testing.assert_array_equal(got, [[7.0, 9.0, 11.0]])


def test_transformix_io_roundtrip(tmp_path):
    """Points and outputpoints files byte-equal to JAX's; the reference's
    column parser reads them back in both."""
    pts_in = np.random.default_rng(3).uniform(0, 100, (7, 3))
    pts_out = pts_in + 1.5
    files = {}
    for tag, module in (("port", ep), ("jax", jep)):
        d = tmp_path / tag
        d.mkdir()
        module.write_transformix_points(str(d / "pts.txt"), pts_in)
        module.write_transformix_output(str(d / "outputpoints.txt"), pts_in, pts_out)
        files[tag] = _tree(str(d))
    assert files["port"] == files["jax"]
    lines = (tmp_path / "port" / "pts.txt").read_text().splitlines()
    assert lines[0] == "point" and lines[1] == "7"
    op = str(tmp_path / "port" / "outputpoints.txt")
    for indices, want in ((False, pts_out), (True, np.rint(pts_out))):
        got = ep.parse_transformix_output(op, indices=indices)
        assert np.array_equal(got, jep.parse_transformix_output(op, indices=indices))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if not indices else 0)
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    assert ep.parse_transformix_output(str(empty)).shape == (0, 3)


@pytest.mark.parametrize("fmt", ["npy", "csv"])
def test_transform_points_native_pipeline(tmp_path, fmt):
    """Two transforms in a row from a .npy or CSV cell file: the same points,
    and the same text files in Aligned_CCF3, as JAX's."""
    A = np.diag([1.5, 1.0, 0.5])
    f0 = tmp_path / "TransformParameters.0.txt"
    _write_affine(f0, A, [1, 2, 3], [0, 0, 0])
    f1 = tmp_path / "TransformParameters.1.txt"
    _write_affine(f1, np.eye(3), [-1, 0, 4], [0, 0, 0])
    cells = np.random.default_rng(4).uniform(0, 50, (12, 3))
    outs = {}
    for tag, module in (("port", ep), ("jax", jep)):
        d = tmp_path / tag
        d.mkdir()
        cf = d / f"cells.{fmt}"
        if fmt == "npy":
            np.save(cf, cells)
        else:
            np.savetxt(cf, cells, delimiter=",", header="x,y,z", comments="")
        outs[tag] = module.transform_points_native(str(cf), [str(f0), str(f1)])
        assert os.path.exists(d / "Aligned_CCF3" / "outputpoints.txt")
    assert np.array_equal(outs["port"], outs["jax"])
    np.testing.assert_allclose(outs["port"], cells @ A.T + [0, 2, 7], rtol=0, atol=1e-9)
    assert (_tree(str(tmp_path / "port" / "Aligned_CCF3"))
            == _tree(str(tmp_path / "jax" / "Aligned_CCF3")))


# ---------------- brainrender render drivers ----------------


def test_camera_presets_complete_and_resolvable():
    assert br.CAMERAS == jbr.CAMERAS
    assert set(br.CAMERAS) == {
        "techpaper_cam_01", "cFosCamera_01", "cFosCamera_02", "cFos_Fig4_camera_01",
        "cFos_sagittal", "cFos_coronal", "cFos_top",
    }
    for name, cam in br.CAMERAS.items():
        resolved = br.resolve_camera(name)
        assert resolved == cam == jbr.resolve_camera(name) and resolved is not cam
        assert set(cam) == {"pos", "viewup", "clippingRange", "focalPoint", "distance"}
    assert br.resolve_camera(None) is None
    explicit = {"pos": (0, 0, 0)}
    assert br.resolve_camera(explicit) is explicit
    with pytest.raises(KeyError):
        br.resolve_camera("nope")


@pytest.mark.parametrize("kw", [
    dict(cells_color="red", region_to_extract="CA1", camera="cFos_coronal"),
    dict(region_to_extract=["CA1", "DG"], camera="cFos_sagittal",
         animation={"type": "turntable", "azimuth": -2.0, "fps": 15}),
    dict(density=True, region_to_extract="grey"),
    dict(density=True, animation={"type": "turntable"}),
    dict(region_to_extract="HIP", camera=None, radius=7.5, alpha=0.5),
])
def test_scene_specs_equal_jax(kw):
    """Single region, multi-region video, density screenshot and video, an
    explicit radius: the same spec, JSON-serializable."""
    spec = br.build_scene_spec(CELLS, "brain7", **kw)
    assert spec == jbr.build_scene_spec(CELLS, "brain7", **kw)
    assert json.dumps(spec) == json.dumps(jbr.build_scene_spec(CELLS, "brain7", **kw))
    assert spec["n_cells"] == 2


def test_single_region_screenshot_spec():
    spec = br.build_scene_spec(CELLS, "brain7", cells_color="red",
                               region_to_extract="CA1", camera="cFos_coronal")
    assert spec["name"] == "cells_video_CA1_brain7"
    assert spec["regions"] == [{"acronym": "CA1", "alpha": 0.2}]
    (actor,) = spec["actors"]
    assert actor == {"type": "points", "subset_region": "CA1", "colors": "red",
                     "alpha": 0.2, "res": 5, "radius": 15.0}
    assert spec["camera"] == br.CAMERAS["cFos_coronal"]


def test_multi_region_video_spec_colors_by_region():
    anim = {"type": "turntable", "azimuth": -2.0, "fps": 15}
    spec = br.build_scene_spec(CELLS, "brain7", region_to_extract=["CA1", "DG"],
                               camera="cFos_sagittal", animation=anim)
    assert spec["name"] == "cells_video_brain7"
    assert [a["subset_region"] for a in spec["actors"]] == ["CA1", "DG"]
    assert all(a["colors"] == "region" and a["radius"] == 3 for a in spec["actors"])
    assert spec["animation"] == anim and spec["animation"] is not anim


def test_density_spec_swaps_actor_and_prefix():
    spec = br.build_scene_spec(CELLS, "brain7", density=True, region_to_extract="grey")
    assert spec["name"] == "density_video_grey_brain7"
    (actor,) = spec["actors"]
    assert actor["type"] == "points_density" and actor["dims"] == [100, 100, 100]
    assert actor["colormap"] == "twilight" and actor["radius"] == 750
    anim = br.build_scene_spec(CELLS, "b", density=True, animation={"type": "turntable"})
    assert anim["actors"][0]["radius"] == 500


def _brainrender_missing():
    try:
        import brainrender  # noqa: F401
    except ImportError:
        return True
    return False


def test_headless_screenshot_exports_spec(tmp_path):
    """Without brainrender: the scene JSON and point cloud, byte-equal to
    JAX's; strict raises the port's BrainRenderUnavailable. Also the
    screenshot through brainrender_export, as tests/test_elastix_points.py
    calls it."""
    if not _brainrender_missing():
        pytest.skip("brainrender installed; headless fallback not exercised")
    kw = dict(region_to_extract="CA1", camera="cFos_top")
    out = br.render_screenshot(str(tmp_path / "port"), CELLS, "brainX", **kw)
    jbr.render_screenshot(str(tmp_path / "jax"), CELLS, "brainX", **kw)
    assert out.endswith("cells_video_CA1_brainX_scene.json")
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    spec = json.load(open(out))
    assert spec["camera"]["viewup"] == [-1, 0, 0]
    pts = np.load(os.path.join(str(tmp_path / "port"), spec["points_file"]))
    np.testing.assert_array_equal(pts, CELLS)
    with pytest.raises(br.BrainRenderUnavailable):
        br.render_screenshot(str(tmp_path / "strict"), CELLS, "brainX", strict=True)

    cells = np.random.default_rng(5).uniform(0, 1000, (20, 3))
    spec_file = be.render_screenshot(str(tmp_path / "shots"), cells, "m1",
                                     region_to_extract="HIP")
    jbe.render_screenshot(str(tmp_path / "jshots"), cells, "m1", region_to_extract="HIP")
    assert _tree(str(tmp_path / "shots")) == _tree(str(tmp_path / "jshots"))
    assert json.load(open(spec_file))["camera"]["focalPoint"] == [6888, 3571, -5717]


def test_headless_video_exports_spec_with_reference_animation(tmp_path):
    if not _brainrender_missing():
        pytest.skip("brainrender installed; headless fallback not exercised")
    out = br.render_video(str(tmp_path / "port"), CELLS, "brainY",
                          region_to_extract=["CA1", "DG"], density=True)
    jbr.render_video(str(tmp_path / "jax"), CELLS, "brainY",
                     region_to_extract=["CA1", "DG"], density=True)
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    spec = json.load(open(out))
    assert spec["animation"] == {"type": "turntable", "azimuth": -2.0, "elevation": 0,
                                 "duration": 30.0, "fps": 15, "size": "3840x3840"}
    assert spec["name"] == "density_video_brainY"
