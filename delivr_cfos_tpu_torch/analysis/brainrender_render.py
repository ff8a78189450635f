"""BrainRender render drivers: screenshot + turntable video + density clouds.

Rebuild of the reference's offline render drivers
(reference: 2021_preprocess_for_brainrender_v13.py — ``render_screenshot``
:180-260, ``mbrainaligner_atlas_to_ccf`` :309-331, ``render_videos``
:333-400, camera presets :435-493). Design split:

- :func:`build_scene_spec` is PURE — it resolves camera presets, region
  lists, point/density actor parameters and the artifact name into one
  JSON-serializable dict. This is the part unit tests pin without any GL
  or brainrender dependency.
- :func:`render_screenshot` / :func:`render_video` execute a spec: with
  brainrender/vedo importable they build the actual ``Scene`` (region
  meshes, ``Points``/``PointsDensity`` actors, ``VideoMaker`` for videos)
  and write the screenshot/video artifacts; without them they write the
  spec JSON (plus the point cloud) next to the intended artifact and raise
  :class:`BrainRenderUnavailable` ONLY when ``strict=True`` — the default
  mirrors the reference's out-of-pipeline usage where the spec export is
  the useful artifact on headless hosts.

Reference semantics preserved:
- region subsetting per region via ``mesh.insidePoints`` (ref :224-229);
- multi-region videos color each region's cell subset with the region
  mesh's own ambient color (ref render_videos :373-379);
- density mode replaces the points actor with a ``PointsDensity`` cloud,
  ``dims=(100,100,100)``, colormap "twilight" (ref :282-287, :368-370)
  and prefixes the artifact name with ``density_``;
- video = 30 s at 15 fps turntable, azimuth −2°/frame, 3840×3840
  (ref :392-396);
- the artifact base name is ``cells_video_{region}_{output_name}``
  (ref :216, :252, :298).

The port's copy of ``delivr_cfos_tpu/analysis/brainrender_render.py``, on the host.
"""

from __future__ import annotations

import json
import os

import numpy as np

# camera presets from the reference's render drivers
# (2021_preprocess_for_brainrender_v13.py:435-493)
CAMERAS = {
    "techpaper_cam_01": {
        "pos": (2093, 2345, -49727),
        "viewup": (0, -1, 0),
        "clippingRange": (33881, 52334),
        "focalPoint": (6888, 3571, -5717),
        "distance": 44288,
    },
    "cFosCamera_01": {
        "pos": (-10104, -18549, 28684),
        "viewup": (0, -1, 0),
        "clippingRange": (25755, 66938),
        "focalPoint": (6888, 3571, -5717),
        "distance": 44288,
    },
    "cFosCamera_02": {
        "pos": (-23429, -13179, 21883),
        "viewup": (0, -1, 0),
        "clippingRange": (23916, 68797),
        "focalPoint": (6888, 3571, -5717),
        "distance": 44288,
    },
    "cFos_Fig4_camera_01": {
        "pos": (-23001, -17333, 19405),
        "viewup": (0, -1, 0),
        "clippingRange": (25524, 67824),
        "focalPoint": (6888, 3571, -5717),
        "distance": 44288,
    },
    "cFos_sagittal": {
        "pos": (8525, 2656, -49965),
        "viewup": (0, -1, 0),
        "clippingRange": (32907, 58823),
        "focalPoint": (6888, 3571, -5717),
        "distance": 44288,
    },
    "cFos_coronal": {
        "pos": (-37318, 916, -6157),
        "viewup": (0, -1, 0),
        "clippingRange": (29896, 61881),
        "focalPoint": (6888, 3571, -5717),
        "distance": 44288,
    },
    "cFos_top": {
        "pos": (2613, -40510, -5917),
        "viewup": (-1, 0, 0),
        "clippingRange": (35416, 56124),
        "focalPoint": (6888, 3571, -5717),
        "distance": 44288,
    },
}


class BrainRenderUnavailable(RuntimeError):
    """brainrender/vedo are not importable and ``strict=True`` was asked."""


def resolve_camera(camera):
    """A preset name, an explicit dict, or None (interactive default)."""
    if camera is None or isinstance(camera, dict):
        return camera
    if camera in CAMERAS:
        return dict(CAMERAS[camera])
    raise KeyError(
        f"unknown camera preset {camera!r}; presets: {sorted(CAMERAS)}"
    )


def build_scene_spec(
    cells: np.ndarray,
    output_name: str,
    cells_color="red",
    region_to_extract="grey",
    camera="cFosCamera_01",
    density: bool = False,
    animation: dict | None = None,
    radius: float = 15.0,
    alpha: float = 0.2,
) -> dict:
    """Resolve everything a render needs into one JSON-serializable dict.

    Mirrors the reference's scene assembly (ref :222-298): regions become
    per-region actors (multi-region lists color each region's cell subset
    by the region mesh color, ``colors="region"``), density mode swaps the
    points actor for a PointsDensity cloud and renames the artifact.
    """
    regions = (
        list(region_to_extract)
        if isinstance(region_to_extract, (list, tuple))
        else [region_to_extract]
    )
    multi = isinstance(region_to_extract, (list, tuple))
    # ref :216/:252: "cells_" + "video_" + region + "_" + output_name
    # (single-region names carry the region, list names don't, ref :254/:334)
    base = (
        f"video_{output_name}" if multi else f"video_{regions[0]}_{output_name}"
    )
    name = ("density_" if density else "cells_") + base

    if density:
        actors = [
            {
                "type": "points_density",
                "dims": [100, 100, 100],
                "colormap": "twilight",
                "radius": 750 if animation is None else 500,  # ref :285/:369
            }
        ]
    elif multi:
        # each region subsets + colors its own cells (ref :373-379)
        actors = [
            {
                "type": "points",
                "subset_region": r,
                "colors": "region",
                "alpha": 0.4,
                "res": 5,
                "radius": 3 if animation is not None else radius,  # ref :379
            }
            for r in regions
        ]
    else:
        actors = [
            {
                "type": "points",
                "subset_region": regions[0],
                "colors": cells_color,
                "alpha": alpha,
                "res": 5,
                "radius": radius,
            }
        ]

    spec = {
        "title": None,
        "inset": None,
        "n_cells": int(np.asarray(cells).shape[0]),
        "regions": [{"acronym": r, "alpha": 0.2} for r in regions],
        "actors": actors,
        "camera": resolve_camera(camera),
        "name": name,
    }
    if animation is not None:
        spec["animation"] = dict(animation)
    return spec


def _try_import_brainrender():
    try:
        import brainrender  # noqa: F401
        from brainrender import Scene
        from brainrender.actors import Points, PointsDensity

        return Scene, Points, PointsDensity
    except ImportError:
        return None


def _export_spec(folder: str, cells: np.ndarray, spec: dict, strict: bool):
    os.makedirs(folder, exist_ok=True)
    pts_file = os.path.join(folder, spec["name"] + "_points.npy")
    np.save(pts_file, np.asarray(cells))
    spec = dict(spec, points_file=os.path.basename(pts_file))
    spec_file = os.path.join(folder, spec["name"] + "_scene.json")
    with open(spec_file, "w") as f:
        json.dump(spec, f, indent=2)
    if strict:
        raise BrainRenderUnavailable(
            "brainrender/vedo are not installed in this environment; the "
            f"full scene specification was exported to {spec_file} — "
            "install brainrender (pip install brainrender) and re-run, or "
            "render the spec externally"
        )
    return spec_file


def _build_scene(Scene, Points, PointsDensity, folder, cells, spec):
    scene = Scene(title=None, screenshots_folder=folder, inset=None)
    pts = np.asarray(cells, np.float64)
    meshes = {}
    for reg in spec["regions"]:
        meshes[reg["acronym"]] = scene.add_brain_region(
            reg["acronym"], alpha=reg["alpha"]
        )
    for actor in spec["actors"]:
        if actor["type"] == "points_density":
            scene.add(
                PointsDensity(
                    pts,
                    dims=tuple(actor["dims"]),
                    colormap=actor["colormap"],
                    radius=actor["radius"],
                )
            )
            continue
        sub = pts
        region = actor.get("subset_region")
        if region is not None and region in meshes:
            sub = meshes[region].mesh.insidePoints(pts).points()
        color = actor["colors"]
        if color == "region":
            color = meshes[region].mesh.property.GetAmbientColor()
        scene.add(
            Points(
                sub,
                colors=color,
                alpha=actor["alpha"],
                res=actor["res"],
                radius=actor["radius"],
            )
        )
    return scene


def render_screenshot(
    screenshots_folder: str,
    cells: np.ndarray,
    output_name: str,
    cells_color="red",
    region_to_extract="grey",
    camera="cFosCamera_01",
    density: bool = False,
    strict: bool = False,
    **actor_kwargs,
) -> str:
    """Build the scene and write ``{name}.png`` (ref render_screenshot
    :180-260). Returns the artifact path; without brainrender, exports the
    scene spec instead (raises :class:`BrainRenderUnavailable` if
    ``strict``)."""
    spec = build_scene_spec(
        cells, output_name, cells_color, region_to_extract, camera,
        density=density, **actor_kwargs,
    )
    br = _try_import_brainrender()
    if br is None:
        return _export_spec(screenshots_folder, cells, spec, strict)
    Scene, Points, PointsDensity = br
    os.makedirs(screenshots_folder, exist_ok=True)
    scene = _build_scene(Scene, Points, PointsDensity,
                         screenshots_folder, cells, spec)
    scene.render(camera=spec["camera"], interactive=False)
    shot = scene.screenshot(name=spec["name"])
    scene.close()
    return shot


def render_video(
    video_folder: str,
    cells: np.ndarray,
    output_name: str,
    cells_color="red",
    region_to_extract="grey",
    camera="cFos_sagittal",
    density: bool = False,
    duration: float = 30.0,
    fps: int = 15,
    azimuth: float = -2.0,
    size: str = "3840x3840",
    strict: bool = False,
) -> str:
    """Turntable video via brainrender's VideoMaker (ref render_videos
    :333-400: azimuth −2°/frame, 30 s at 15 fps, 3840×3840). Returns the
    video path; spec-JSON fallback as in :func:`render_screenshot`."""
    animation = {
        "type": "turntable",
        "azimuth": azimuth,
        "elevation": 0,
        "duration": duration,
        "fps": fps,
        "size": size,
    }
    spec = build_scene_spec(
        cells, output_name, cells_color, region_to_extract, camera,
        density=density, animation=animation,
    )
    br = _try_import_brainrender()
    if br is None:
        return _export_spec(video_folder, cells, spec, strict)
    Scene, Points, PointsDensity = br
    from brainrender.video import VideoMaker

    os.makedirs(video_folder, exist_ok=True)
    scene = _build_scene(Scene, Points, PointsDensity, video_folder, cells, spec)
    vm = VideoMaker(scene, video_folder, spec["name"], size=size)
    out = vm.make_video(
        azimuth=azimuth, elevation=0, duration=duration, fps=fps
    )
    scene.close()
    return out if isinstance(out, str) else os.path.join(
        video_folder, spec["name"] + ".mp4"
    )
