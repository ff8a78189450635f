"""Stage 4 — atlas registration + cell-coordinate warping.

The port's counterpart of ``delivr_cfos_tpu/pipeline/stage04_atlas_align.py``
(reference: automate_mBrainaligner.py:437-506, ``run_mbrainaligner_and_swc_reg``).
The three mBrainAligner C++ binaries are replaced by the registration of
``registration/`` (affine + B-spline FFD as autograd loops on the device);
point warping is one batched evaluation over all cells.

Pipeline per brain:
1. fixed volume  = the 8-bit masked downsampled brain
   ({mask_output}/{brain}/stack_masked_downsampled.v3draw, reference :453),
   cropped to its nonzero extent (the padding stage 1 adds is trailing);
2. moving volume = the 50 µm atlas average template
   (config atlas_alignment.template_file) in (z, y, x) = (228, 160, 264);
   without a template a geometric scale-into-atlas-box fallback is used so
   the pipeline stays runnable (clearly logged — counts are then
   unregistered);
3. affine (+ optional B-spline FFD) optimization, fixed→moving;
4. cells: stage-3 CSV ("[z, y, x]" Coords strings, reference :88-114) →
   full-res coords ÷ per-axis downsampling factors (original dims parsed
   from the "(Z, Y, X)" CSV filename / stack_resampled.tif shape, reference
   :261-284) → through the transform → mBrainAligner 50 µm atlas space.

Output contract (reference :237-258), the JAX package's bytes: SWC stages
written to {atlas_output}/{mouse}/, and
``{mouse}_local_registered_with_original_size.csv`` (space-separated,
columns n type x y z Size, after a ``# registration_mode:`` line) written to
both the output dir and the collection folder, plus ``transform.npz``. The
tables are read and written without pandas (``registration/swc.py``); the
cells' coordinates stay float64 on the host, and only the (N, 3) float32
warp runs on the device.
"""

from __future__ import annotations

import csv
import os
import re

import numpy as np

from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.registration.affine import (
    register_affine,
    register_affine_multistart,
)
from delivr_cfos_tpu_torch.registration.bspline import register_bspline, warp_points
from delivr_cfos_tpu_torch.registration.landmarks import (
    read_marker_file,
    register_affine_landmarks,
)
from delivr_cfos_tpu_torch.registration.swc import (
    swc_frame_from_cells,
    write_rows,
    write_swc,
)
from delivr_cfos_tpu_torch.utils.device import StepSeconds, resolve_device, timed
from delivr_cfos_tpu_torch.utils.io.nrrd import read_nrrd
from delivr_cfos_tpu_torch.utils.io.tiff import read_tiff, tiff_page_infos
from delivr_cfos_tpu_torch.utils.io.v3draw import read_v3draw
from delivr_cfos_tpu_torch.utils.logging import log

ATLAS_SHAPE_ZYX = (228, 160, 264)  # mBrainAligner 50 µm target (-c, -b, -a)


def parse_shape_from_name(path: str) -> tuple:
    """Extract the "(Z, Y, X)" tuple embedded in the stage-3 CSV filename
    (reference: automate_mBrainaligner.py:199-213)."""
    name = os.path.basename(path)
    inside = re.findall(r"\(([^)]+)", name)[0]
    return tuple(int(v) for v in inside.replace(" ", "").split(","))


def parse_blob_csv(csv_path: str) -> dict:
    """Stage-3 CSV → columns z, y, x (float64, rounded to 3 digits) and Size
    (int64); the row number is the cell number (reference rewrite_swc string
    munging, automate_mBrainaligner.py:75-127). The same string steps as
    the JAX package's pandas calls: runs of whitespace to one space, the
    brackets dropped, split on commas and whitespace."""
    with open(csv_path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, body = rows[0], rows[1:]
    ci, si = header.index("Coords"), header.index("Size")
    zyx = np.zeros((len(body), 3), np.float64)
    for n, r in enumerate(body):
        s = re.sub(r"\s{2,}", " ", r[ci]).replace("[", "").replace("]", "").strip()
        zyx[n] = [float(t) for t in re.split(r"[,\s]+", s)[:3]]
    zyx = np.round(zyx, 3)
    return {"z": zyx[:, 0], "y": zyx[:, 1], "x": zyx[:, 2],
            "Size": np.array([int(r[si]) for r in body], np.int64)}


def _load_template(path: str):
    """50 µm average-template volume, (z, y, x) = (228, 160, 264).
    ``scripts/fetch_allen_template.py`` documents how to obtain/convert it
    from the Allen informatics archive (average_template_50.nrrd reads as
    exactly this shape in C order)."""
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".v3draw"):
        return read_v3draw(path).astype(np.float32)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".nrrd"):
        return read_nrrd(path)[0].astype(np.float32)
    return read_tiff(path).astype(np.float32)


def _fallback_affine(fixed_shape) -> np.ndarray:
    """Scale the brain volume into the atlas box (unregistered fallback)."""
    scale = [ATLAS_SHAPE_ZYX[i] / fixed_shape[i] for i in range(3)]
    aff = np.zeros((3, 4), np.float32)
    aff[0, 0], aff[1, 1], aff[2, 2] = scale
    return aff


def crop_trailing_zeros(fixed: np.ndarray) -> np.ndarray:
    """``fixed`` cut to its nonzero extent. The v3draw carries the
    TeraConverter-era ≥250 px zero padding (reference:
    downsample_and_mask.py:227-240, reproduced by stage 1's _pad_under_250);
    it is trailing-only, so the crop leaves every coordinate unchanged while
    shrinking the registration grid. Per-axis any() reductions: O(max-dim)
    memory, against np.nonzero's three full index arrays."""
    axes = [(1, 2), (0, 2), (0, 1)]
    extents = [np.flatnonzero(fixed.any(axis=ax)) for ax in axes]
    if not extents[0].size:
        return fixed
    return fixed[
        : int(extents[0][-1]) + 1,
        : int(extents[1][-1]) + 1,
        : int(extents[2][-1]) + 1,
    ]


def resolve_registration(aa, fixed: np.ndarray, device=None, timer=None):
    """Pick the registration path from the config (returns
    (affine, field, mode)):

    1. ``landmarks_hemisphere`` + marker files → landmark least-squares
       affine (reference ``-p a`` mode, automate_mBrainaligner.py:40-56),
       NCC-refined when a template is also configured;
    2. template only → multi-resolution NCC affine (+ optional FFD);
    3. neither → geometric scale-into-atlas-box fallback (logged loudly).

    The optimizers run on ``device`` (None: the card); ``timer`` (a
    ``StepSeconds``) gets "template" and the registration's steps.
    """
    dev = resolve_device(device)
    with timed(timer, "template"):
        template = _load_template(aa.template_file)
    field = None

    use_landmarks = (
        aa.landmarks_hemisphere
        and aa.landmarks_file
        and os.path.exists(aa.landmarks_file)
        and aa.atlas_landmarks_file
        and os.path.exists(aa.atlas_landmarks_file)
    )
    if aa.landmarks_hemisphere and not use_landmarks:
        log(
            "WARNING: landmarks_hemisphere is set but landmarks_file/"
            "atlas_landmarks_file are missing — falling back to intensity "
            "registration"
        )

    if use_landmarks:
        src = read_marker_file(aa.landmarks_file)
        dst = read_marker_file(aa.atlas_landmarks_file)
        affine, ncc = register_affine_landmarks(
            fixed, template, src, dst, refine=template is not None,
            device=dev, timer=timer,
        )
        mode = "landmarks+ncc" if template is not None else "landmarks"
        if ncc is not None:
            log(f"Landmark affine refined to NCC {ncc:.4f}")
    elif template is not None:
        if aa.multistart:
            affine, ncc, flip = register_affine_multistart(
                fixed, template, similarity=aa.similarity,
                n_samples=aa.n_samples, device=dev, timer=timer,
            )
            if flip:
                log(f"Multi-start winner flipped axes {flip}")
        else:
            affine, ncc = register_affine(
                fixed, template, similarity=aa.similarity,
                n_samples=aa.n_samples, device=dev, timer=timer,
            )
        log(f"Affine {aa.similarity.upper()} {ncc:.4f}")
        mode = f"intensity-{aa.similarity}"
    else:
        log(
            "WARNING: no atlas template configured "
            "(atlas_alignment.template_file) — using geometric scale fallback; "
            "region counts will be unregistered."
        )
        affine = _fallback_affine(fixed.shape)
        mode = "fallback"
    if template is not None and aa.use_ffd:
        field, _ = register_bspline(
            fixed, template, affine, spacing=aa.ffd_spacing,
            similarity=aa.similarity, levels=tuple(aa.ffd_levels),
            n_samples=aa.n_samples, device=dev, timer=timer,
        )
    return affine, field, mode


def run_registration_and_point_warp(cfg: PipelineConfig, entry_csv: str,
                                    device=None) -> dict:
    """Register the brain of stage 3's ``entry_csv`` to the atlas and warp
    its cells, on ``device`` (None: the card; raises where there is none).
    Returns the seconds by step."""
    dev = resolve_device(device)
    timer = StepSeconds(dev)
    aa = cfg.atlas_alignment
    entry_folder = os.path.basename(entry_csv).replace(".csv", "")
    brain = "_".join(entry_folder.split("_")[1:])
    mouse_name = brain

    mask_out = os.path.join(cfg.mask_detection.output_location, brain)
    v3draw_path = os.path.join(mask_out, "stack_masked_downsampled.v3draw")
    tiff_path = os.path.join(mask_out, "stack_resampled.tif")

    output_dir = os.path.join(aa.output_location, mouse_name)
    os.makedirs(output_dir, exist_ok=True)
    os.makedirs(aa.collection_folder, exist_ok=True)

    with timer.step("load"):
        fixed = read_v3draw(v3draw_path).astype(np.float32)
    with timer.step("crop"):
        fixed = crop_trailing_zeros(fixed)

    # ---- registration -----------------------------------------------------
    log("Registering", brain)
    affine, field, reg_mode = resolve_registration(aa, fixed, device=dev, timer=timer)
    log("Registration mode:", reg_mode)

    np.savez(
        os.path.join(output_dir, "transform.npz"),
        affine=affine,
        ffd_ctrl=(field.ctrl if field is not None else np.zeros((0,))),
        ffd_spacing=(field.spacing if field is not None else 0.0),
        fixed_shape=np.asarray(fixed.shape),
        # self-identifying provenance: a 'fallback' mode means the counts
        # downstream are NOT atlas-registered
        mode=np.bytes_(reg_mode.encode()),
    )

    # ---- cell-point warping ----------------------------------------------
    cells = parse_blob_csv(entry_csv)
    orig_z, orig_y, orig_x = parse_shape_from_name(entry_csv)
    # downsample factors from the unpadded resampled stack, reference :261-284
    infos = tiff_page_infos(tiff_path)
    ds_shape = (len(infos), infos[0].shape[0], infos[0].shape[1])
    ds_f = (orig_z / ds_shape[0], orig_y / ds_shape[1], orig_x / ds_shape[2])

    # resampled SWC (downsampled brain space), float64 as pandas divides
    rz, ry, rx = cells["z"] / ds_f[0], cells["y"] / ds_f[1], cells["x"] / ds_f[2]
    size = cells["Size"]
    write_swc(os.path.join(output_dir, f"{mouse_name}_resampled.swc"),
              swc_frame_from_cells(rx, ry, rz, size))

    pts_zyx = np.stack([rz, ry, rx], axis=1).astype(np.float32)
    with timer.step("point_warp"):
        atlas_zyx = warp_points(affine, field, pts_zyx, device=dev)
        # global (affine-only) SWC for parity with the reference's stage outputs
        glob_zyx = warp_points(affine, None, pts_zyx, device=dev)
    with timer.step("write"):
        write_swc(
            os.path.join(output_dir, f"{mouse_name}_global_data.swc"),
            swc_frame_from_cells(glob_zyx[:, 2], glob_zyx[:, 1], glob_zyx[:, 0], size),
        )
        write_swc(
            os.path.join(output_dir, f"{mouse_name}_local_registered_data.swc"),
            swc_frame_from_cells(atlas_zyx[:, 2], atlas_zyx[:, 1], atlas_zyx[:, 0], size),
        )

        # ---- final collection CSV (reference reattach_size_and_copy :237-258)
        columns = [
            np.arange(len(size)),
            np.ones(len(size), np.int64),
            *(np.round(atlas_zyx[:, k].astype(np.float64), 3) for k in (2, 1, 0)),
            size,
        ]
        out_name = f"{mouse_name}_local_registered_with_original_size.csv"
        # the registration mode leads as a comment so fallback (unregistered)
        # runs are self-identifying in the science outputs; stage 5 reads
        # with comment='#'
        for dest in (
            os.path.join(output_dir, out_name),
            os.path.join(aa.collection_folder, out_name),
        ):
            with open(dest, "w") as f:
                f.write(f"# registration_mode: {reg_mode}\n")
                f.write("n type x y z Size\n")
                write_rows(f, columns)
    log("Atlas registration finished", mouse_name)
    return dict(timer)
