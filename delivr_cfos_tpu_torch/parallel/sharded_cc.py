"""Connected-component labeling z-sharded over a device mesh.

The port's counterpart of ``delivr_cfos_tpu/parallel/sharded_cc.py``. The
volume is cut into equal z-slabs, one a shard on its device; every
foreground voxel starts with its GLOBAL linear index as its label, and each
round

1. copies each shard's boundary planes to its neighbours (the mesh's outer
   edges see the sentinel),
2. takes the 26-neighbourhood minimum over [halo_lo | slab | halo_hi],
3. pointer-jumps three times through labels that point into the shard
   itself (a label that points into another shard waits for that shard's
   minimum to arrive through the halo),

until no shard's labels changed. cFos blobs span a handful of voxels, so a
component crosses few boundaries and the rounds stay few. The labels are
global-minimum linear indices, as the single-device engine's are, so the
shared canonicalization numbers them identically.
"""

from __future__ import annotations

import numpy as np
import torch

from delivr_cfos_tpu_torch.ops.connected_components import (
    _canonicalize_raw_labels,
    _neighbor_min,
)
from delivr_cfos_tpu_torch.parallel.mesh import Mesh
from delivr_cfos_tpu_torch.parallel.sharded_inference import _canonical, _copy_to, _slab_on


def _jump(flat, fg_flat, base: int, n_local: int, sentinel):
    """One pointer jump through labels that point into this shard."""
    loc = flat - base
    in_range = (loc >= 0) & (loc < n_local)
    jumped = torch.where(in_range, flat[loc.clamp(0, n_local - 1).long()], flat)
    return torch.where(fg_flat, torch.minimum(flat, jumped), sentinel)


def label_volume_sharded(mesh: Mesh, binary, mesh_axis: str = "sp", *,
                         return_rounds: bool = False):
    """26-connected labeling of a (Z, Y, X) volume z-sharded over the
    ``mesh_axis`` devices of ``mesh``. Returns (labels int32 canonical 1..N
    in raster order, n), and the rounds it took with ``return_rounds``: the
    numbering of the host engine."""
    devices = [_canonical(d) for d in mesh.axis_devices(mesh_axis)]
    n_sp = len(devices)
    z, y, x = binary.shape
    zloc = -(-z // n_sp)
    if n_sp * zloc * y * x + 1 >= 2**31:
        # labels are GLOBAL int32 linear voxel indices (base = rank·n_local);
        # past 2^31 voxels they would overflow silently
        raise ValueError(
            f"padded volume has {n_sp * zloc * y * x} voxels, exceeding the int32 "
            "global label space of the sharded labeler; use label_out_of_core"
        )
    n_local = zloc * y * x
    big = n_sp * n_local + 1
    fgs, lbls, sentinels = [], [], []
    for k, d in enumerate(devices):
        fg = _slab_on(binary, k * zloc, min((k + 1) * zloc, z), (zloc, y, x), d) > 0
        sentinel = torch.full((), big, dtype=torch.int32, device=d)
        idx = torch.arange(n_local, dtype=torch.int32, device=d).reshape(fg.shape)
        fgs.append(fg)
        sentinels.append(sentinel)
        lbls.append(torch.where(fg, idx + k * n_local, sentinel))

    # the mesh's outer edges see the sentinel
    edge_lo = torch.full((1, y, x), big, dtype=torch.int32, device=devices[0])
    edge_hi = torch.full((1, y, x), big, dtype=torch.int32, device=devices[-1])
    rounds = 0
    while True:
        rounds += 1
        # every shard's halos from the labels of the round before
        lo = [_copy_to(lbls[k - 1][-1:], d) if k else edge_lo for k, d in enumerate(devices)]
        hi = [_copy_to(lbls[k + 1][:1], d) if k + 1 < n_sp else edge_hi
              for k, d in enumerate(devices)]
        nxts, changed = [], []
        for k in range(n_sp):
            lbl, fg, sentinel = lbls[k], fgs[k], sentinels[k]
            ext = torch.cat([lo[k], lbl, hi[k]])
            nxt = torch.where(fg, torch.minimum(lbl, _neighbor_min(ext)[1:-1]), sentinel)
            flat = nxt.reshape(-1)
            for _ in range(3):
                flat = _jump(flat, fg.reshape(-1), k * n_local, n_local, sentinel)
            nxt = flat.reshape(lbl.shape)
            changed.append((nxt != lbl).any())
            nxts.append(nxt)
        lbls = nxts
        if not any(bool(c) for c in changed):
            break
    raw = np.concatenate([
        torch.where(fg, lbl, torch.full_like(lbl, -1)).cpu().numpy()
        for fg, lbl in zip(fgs, lbls)
    ])[:z]
    labels, n = _canonicalize_raw_labels(raw)
    return (labels, n, rounds) if return_rounds else (labels, n)
