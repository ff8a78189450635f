"""A brain phantom from the seed, made on the device, and written in the
stage-1 layout that stage 2 reads.

Tissue is an ellipsoid of the brain's extent; the volume may be a z-range of
that brain (a section). Outside the ellipsoid every voxel is exactly 0, as
stage 1's mask leaves it. Inside: a background texture (a coarse random
field, trilinearly interpolated, plus voxel noise) and cFos+ nuclei as
Gaussian blobs. The number of nuclei is fixed by the tissue volume, so
every seed makes the same amount of work; the seed moves where the nuclei
lie, how bright and wide they are, and the texture.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

MAX_U16 = 65535


def sub_seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds from any whole number."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(s) & (2**63 - 1) for s in state]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _axis_terms(traffic: dict, device):
    """Per-axis ((coordinate − centre) / semi-axis)² of the voxel centres,
    in the brain's frame, each shaped to broadcast over (Z, Y, X)."""
    shape = traffic["volume_zyx"]
    brain = traffic["brain_zyx"]
    offset = traffic["offset_zyx"]
    ell = traffic["ellipsoid"]
    terms = []
    for ax in range(3):
        c = ell["center_frac"][ax] * brain[ax]
        a = ell["semi_axes_frac"][ax] * brain[ax] / 2
        x = torch.arange(shape[ax], device=device, dtype=torch.float64) + offset[ax] + 0.5
        t = ((x - c) / a) ** 2
        view = [1, 1, 1]
        view[ax] = shape[ax]
        terms.append(t.view(view))
    return terms


def tissue_mask(traffic: dict, device) -> torch.Tensor:
    """bool (Z, Y, X): the voxels inside the ellipsoid."""
    tz, ty, tx = _axis_terms(traffic, device)
    return (tz + ty + tx) <= 1.0


def make_phantom(traffic: dict, seed: int, device) -> torch.Tensor:
    """int32 (Z, Y, X) on ``device`` with uint16 values."""
    shape = tuple(traffic["volume_zyx"])
    tex = traffic["texture"]
    nuc = traffic["nuclei"]
    s_tex, s_noise, s_nuc = sub_seeds(seed, 3)
    tissue = tissue_mask(traffic, device)

    # texture: a coarse uniform field on a grid of ``coarse_step`` voxels,
    # trilinear between its points, and per-voxel Gaussian noise
    step = int(tex["coarse_step"])
    coarse = tuple(math.ceil(n / step) + 1 for n in shape)
    g = generator(s_tex, device)
    field = torch.rand(coarse, generator=g, device=device)
    field = field * (tex["high"] - tex["low"]) + tex["low"]
    vol = F.interpolate(field[None, None], size=shape, mode="trilinear",
                        align_corners=True)[0, 0]
    del field
    g = generator(s_noise, device)
    vol += torch.randn(shape, generator=g, device=device) * tex["voxel_noise_std"]

    # nuclei: a fixed count from the tissue volume, placed in the tissue
    n_tissue = int(tissue.sum())
    n_nuc = int(round(nuc["per_mvox_tissue"] * n_tissue / 1e6))
    if n_nuc:
        _add_nuclei(vol, tissue, n_nuc, nuc, s_nuc, device)

    vol = torch.where(tissue, vol.clamp(1, MAX_U16).round(), 0.0)
    return vol.to(torch.int32)


def nucleus_centres(tissue: torch.Tensor, n: int, g: torch.Generator) -> torch.Tensor:
    """float64 (n, 3): ``n`` points in the tissue's voxels, drawn from
    ``g`` uniformly over the volume in batches of 8·n and kept where they
    fall in the tissue, batch after batch until ``n`` are found. A tissue of
    an eighth of the volume or more as a rule takes one batch."""
    if not bool(tissue.any()):
        raise RuntimeError(f"no tissue to place {n} nucleus centres in")
    extent = torch.tensor(tissue.shape, device=tissue.device, dtype=torch.float64)
    found, count = [], 0
    while count < n:
        cand = torch.rand((8 * n, 3), generator=g, device=tissue.device, dtype=torch.float64)
        cand = cand * extent
        idx = cand.floor().long()
        found.append(cand[tissue[idx[:, 0], idx[:, 1], idx[:, 2]]])
        count += found[-1].shape[0]
    return torch.cat(found)[:n]


def _add_nuclei(vol, tissue, n: int, nuc: dict, seed: int, device) -> None:
    """Add ``n`` Gaussian blobs whose centres lie in the tissue into
    ``vol`` in place, in one scatter-add."""
    shape = vol.shape
    g = generator(seed, device)
    centres = nucleus_centres(tissue, n, g)
    u = torch.rand((n, 3), generator=g, device=device, dtype=torch.float64)
    amp = nuc["amplitude"][0] + u[:, 0] * (nuc["amplitude"][1] - nuc["amplitude"][0])
    s_yx = nuc["sigma_yx"][0] + u[:, 1] * (nuc["sigma_yx"][1] - nuc["sigma_yx"][0])
    s_z = nuc["sigma_z"][0] + u[:, 2] * (nuc["sigma_z"][1] - nuc["sigma_z"][0])
    rz = math.ceil(3 * nuc["sigma_z"][1])
    ryx = math.ceil(3 * nuc["sigma_yx"][1])
    oz = torch.arange(-rz, rz + 1, device=device)
    oyx = torch.arange(-ryx, ryx + 1, device=device)
    base = centres.floor().long()
    pz = base[:, 0, None, None, None] + oz[None, :, None, None]
    py = base[:, 1, None, None, None] + oyx[None, None, :, None]
    px = base[:, 2, None, None, None] + oyx[None, None, None, :]
    # distances from the voxel centres to the blob's sub-voxel centre
    dz = (pz + 0.5 - centres[:, 0, None, None, None]) / s_z[:, None, None, None]
    dy = (py + 0.5 - centres[:, 1, None, None, None]) / s_yx[:, None, None, None]
    dx = (px + 0.5 - centres[:, 2, None, None, None]) / s_yx[:, None, None, None]
    val = amp[:, None, None, None] * torch.exp(-0.5 * (dz * dz + dy * dy + dx * dx))
    pz, py, px = torch.broadcast_tensors(pz, py, px)
    ok = ((pz >= 0) & (pz < shape[0]) & (py >= 0) & (py < shape[1])
          & (px >= 0) & (px < shape[2]))
    flat = (pz * shape[1] + py) * shape[2] + px
    vol.view(-1).index_add_(0, flat[ok], val[ok].to(vol.dtype))


def window_starts(size: int, roi: int, overlap: float) -> list[int]:
    """MONAI's dense window starts along one axis: stride
    int(roi·(1 − overlap)) (the roi where it covers the axis), the last
    start clamped to size − roi."""
    if roi >= size:
        return [0]
    stride = int(roi * (1 - overlap)) or 1
    n = math.ceil((size - roi) / stride) + 1
    return [min(i * stride, size - roi) for i in range(n)]


def active_windows(vol: torch.Tensor, roi, overlap: float, threshold: float = 0) -> tuple[int, int]:
    """(windows with a voxel above ``threshold``, all windows) of the dense
    grid over ``vol``: the windows the model runs on, and the grid."""
    starts = [window_starts(vol.shape[a], roi[a], overlap) for a in range(3)]
    maxes = torch.stack([
        vol[z:z + roi[0], y:y + roi[1], x:x + roi[2]].amax()
        for z in starts[0] for y in starts[1] for x in starts[2]
    ])
    return int((maxes > threshold).sum()), int(maxes.numel())


def write_stage1(vol: torch.Tensor, root: str, brain: str = "brain",
                 planes: int = 64) -> str:
    """Write ``vol`` as stage 1's output, ``<root>/<brain>/masked_niftis/
    masked_nifti.npy``, uint16 (1, 1, Z, Y, X), in blocks of ``planes``.
    Returns the file's path."""
    d = os.path.join(root, brain, "masked_niftis")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "masked_nifti.npy")
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint16,
                                   shape=(1, 1, *vol.shape))
    for z0 in range(0, vol.shape[0], planes):
        mm[0, 0, z0:z0 + planes] = vol[z0:z0 + planes].cpu().numpy().astype(np.uint16)
    mm.flush()
    del mm
    return path
