"""3D connected-component labeling + per-component statistics (replaces cc3d).

The port's copy of ``delivr_cfos_tpu/ops/connected_components.py``. The
reference calls the C++ ``cc3d`` extension with default 26-connectivity and
then ``cc3d.statistics`` for voxel counts / centroids / bounding boxes
(reference: count_blobs.py:61-85, blob_highlighter.py:85-88).

Engines:

- ``label_volume_device``: min-label propagation with pointer jumping in
  torch, on the card unless the caller asks for the CPU — every foreground
  voxel starts as its own int32 linear index and takes the minimum over its
  26-neighbourhood, then follows its label three times, until nothing
  changes. The counterpart of the JAX package's XLA ``lax.while_loop``
  labeler; it is plain torch, not a hand-written kernel.
- ``label_volume_host``: scipy 26-connected two-pass labeling (exact
  reference algorithm class); used for verification and as the default for
  host-side post-processing. The native C++ union-find
  (``native/cc.py``) is the other host engine.
- slab streaming: ``label_out_of_core`` and ``label_slabs_streaming`` label
  z-slabs independently and merge labels across slab faces with a
  union-find, so terabyte volumes never need a global pass.

Label values follow the cc3d/scipy convention: 0 = background, components
numbered 1..N in raster order of first appearance, the same canonical
labeling from every engine, which keeps the downstream CSV contract
deterministic. The host engines are the JAX package's code unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from delivr_cfos_tpu_torch.utils.device import resolve_device

_STRUCT_26 = np.ones((3, 3, 3), dtype=np.uint8)


# --------------------------------------------------------------------------
# host engine (scipy two-pass; exact and fast for post-processing)
# --------------------------------------------------------------------------


def label_volume_host(binary: np.ndarray) -> tuple:
    """26-connected labeling; returns (labels int32, n_components)."""
    labels, n = ndimage.label(binary > 0, structure=_STRUCT_26)
    return labels.astype(np.int32), int(n)


# --------------------------------------------------------------------------
# device engine (label propagation)
# --------------------------------------------------------------------------


def _min3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Minimum over {i − 1, i, i + 1} along ``dim``; beyond the edge counts
    nothing, as padding with the sentinel would. Exact on int32 (a float32
    max-pool would round labels above 2²⁴)."""
    n = t.shape[dim]
    out = t.clone()
    if n > 1:
        inner, lo, hi = out.narrow(dim, 1, n - 1), t.narrow(dim, 0, n - 1), t.narrow(dim, 1, n - 1)
        torch.minimum(inner, lo, out=inner)
        head = out.narrow(dim, 0, n - 1)
        torch.minimum(head, hi, out=head)
    return out


def _neighbor_min(lbl: torch.Tensor) -> torch.Tensor:
    """Min label over the 26-neighbourhood + self: the 3×3×3 minimum is three
    separable 3-wide minima over z, y and x. Background voxels carry the
    sentinel so they never win."""
    return _min3(_min3(_min3(lbl, 0), 1), 2)


def _label_device_impl(fg: torch.Tensor):
    """Min-label propagation with pointer jumping on ``fg`` (bool (Z, Y, X)).

    Every label is the linear index of some foreground voxel, so one gather
    resolves a label to the label stored at that voxel — pointer jumping,
    collapsing chains exponentially. Returns (raw labels int32 with −1 on
    background, rounds); each round ends in one host sync (the test for a
    change)."""
    shape = fg.shape
    n = fg.numel()
    big = n + 1
    fg_flat = fg.reshape(-1)
    sentinel = torch.full((), big, dtype=torch.int32, device=fg.device)
    lbl = torch.where(
        fg, torch.arange(n, dtype=torch.int32, device=fg.device).reshape(shape),
        sentinel,
    )
    rounds = 0
    while True:
        rounds += 1
        nxt = torch.where(fg, torch.minimum(lbl, _neighbor_min(lbl)), sentinel)
        flat = nxt.reshape(-1)
        for _ in range(3):
            # flat[v] points at a foreground voxel for fg v; background is big
            jumped = flat[flat.clamp(0, n - 1).long()]
            flat = torch.where(fg_flat, torch.minimum(flat, jumped), sentinel)
        nxt = flat.reshape(shape)
        changed = bool((nxt != lbl).any())
        lbl = nxt
        if not changed:
            break
    return torch.where(fg, lbl, torch.full_like(lbl, -1)), rounds


def label_volume_device(binary, device=None, *, return_rounds: bool = False):
    """Propagation labeling on ``device`` (None: the card); returns
    (labels int32 canonical 1..N, n), and the rounds it took with
    ``return_rounds``. ``binary``: a (Z, Y, X) numpy array or tensor."""
    n_vox = int(np.prod(tuple(binary.shape)))
    if n_vox + 1 >= 2**31:
        # labels ARE int32 linear voxel indices; a >=2^31-voxel volume would
        # overflow silently — route such volumes to label_out_of_core, which
        # decomposes below this bound
        raise ValueError(
            f"volume has {n_vox} voxels, exceeding the int32 label space of "
            "the device labeler; use label_out_of_core"
        )
    dev = resolve_device(device)
    if isinstance(binary, torch.Tensor):
        fg = binary.to(dev) > 0
    else:
        fg = torch.from_numpy(np.ascontiguousarray(np.asarray(binary) > 0)).to(dev)
    if n_vox == 0:
        raw, rounds = np.full(tuple(binary.shape), -1, np.int32), 0
    else:
        raw_t, rounds = _label_device_impl(fg)
        raw = raw_t.cpu().numpy()
    labels, n = _canonicalize_raw_labels(raw)
    return (labels, n, rounds) if return_rounds else (labels, n)


def _canonicalize_raw_labels(raw: np.ndarray) -> tuple:
    """Map arbitrary root labels (−1 = background) to 1..N in raster order of
    first appearance (the cc3d/scipy numbering convention)."""
    flat = raw.ravel()
    fg = flat >= 0
    roots = flat[fg]
    # order of first appearance in raster order
    uniq, first_idx = np.unique(roots, return_index=True)
    order = np.argsort(first_idx)
    remap = np.empty(uniq.shape[0], dtype=np.int32)
    remap[order] = np.arange(1, uniq.shape[0] + 1, dtype=np.int32)
    out = np.zeros(flat.shape[0], np.int32)
    idx = np.searchsorted(uniq, roots)
    out[fg] = remap[idx]
    labels = out.reshape(raw.shape)
    return labels, int(uniq.shape[0])


# --------------------------------------------------------------------------
# slab streaming with cross-face merging
# --------------------------------------------------------------------------


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, a):
        p = self.parent
        root = a
        while p.get(root, root) != root:
            root = p[root]
        while p.get(a, a) != a:
            p[a], a = root, p[a]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            if rb < ra:
                ra, rb = rb, ra
            self.parent[rb] = ra


def _union_faces(uf: "_UnionFind", prev_plane: np.ndarray, first_plane: np.ndarray):
    """26-connectivity between two consecutive z-planes: union every pair of
    positive labels within a 3×3 (y, x) neighborhood across the face."""
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            a = prev_plane
            b = first_plane
            ay0, ay1 = max(dy, 0), a.shape[0] + min(dy, 0)
            ax0, ax1 = max(dx, 0), a.shape[1] + min(dx, 0)
            by0, by1 = max(-dy, 0), b.shape[0] + min(-dy, 0)
            bx0, bx1 = max(-dx, 0), b.shape[1] + min(-dx, 0)
            av = a[ay0:ay1, ax0:ax1]
            bv = b[by0:by1, bx0:bx1]
            both = (av > 0) & (bv > 0)
            if both.any():
                pairs = np.unique(np.stack([av[both], bv[both]], axis=1), axis=0)
                for pa, pb in pairs:
                    uf.union(int(pa), int(pb))


def _slab_local_label_stats(binary, z0: int, z1: int, label_fn):
    """Label one z-slab and compute its LOCAL statistics (ids 1..n_loc).
    Depends on no other slab — safe on a worker thread (the native labeler
    is a GIL-releasing ctypes call; the numpy reductions release the GIL for
    their inner loops). ``lab`` is returned un-offset; the caller owns it."""
    slab = np.ascontiguousarray(binary[z0:z1])
    lab, n_loc = label_fn(slab)
    lab = lab.astype(np.int32, copy=False)
    fg = lab > 0
    flat = lab[fg]
    zz, yy, xx = np.nonzero(fg)
    cnt = np.bincount(flat, minlength=n_loc + 1)[1:].astype(np.int64)
    cs = np.zeros((n_loc, 3), np.float64)
    if flat.size:
        cs[:, 0] = np.bincount(flat, weights=zz + z0, minlength=n_loc + 1)[1:]
        cs[:, 1] = np.bincount(flat, weights=yy, minlength=n_loc + 1)[1:]
        cs[:, 2] = np.bincount(flat, weights=xx, minlength=n_loc + 1)[1:]
    bb = np.zeros((n_loc, 6), np.int64)
    if flat.size:
        for axis, coords, off in ((0, zz, z0), (1, yy, 0), (2, xx, 0)):
            mins = np.full(n_loc + 1, np.iinfo(np.int64).max)
            maxs = np.full(n_loc + 1, -1)
            np.minimum.at(mins, flat, coords + off)
            np.maximum.at(maxs, flat, coords + off)
            bb[:, 2 * axis] = mins[1:]
            bb[:, 2 * axis + 1] = maxs[1:]
    bg = ~fg
    bg_proj = (bg.any(axis=(1, 2)), bg.any(axis=(0, 2)), bg.any(axis=(0, 1)))
    return lab, n_loc, cnt, cs, bb, bg_proj


def label_out_of_core(
    binary,
    labels_out,
    slab_planes: int = 64,
    label_fn=None,
    workers: int = 0,
):
    """Label a (Z, Y, X) array-like (typically a disk memmap) without ever
    holding the volume — or the label field — in RAM, the TPU-framework
    equivalent of cc3d's ``out_file=`` disk labeling for RAM < 2× dataset
    (reference: count_blobs.py:59-64).

    Two passes over z-slabs of ``slab_planes``:

    1. label each slab independently (``label_fn``: native C++ union-find or
       scipy two-pass), offset to globally unique provisional ids, write the
       provisional labels into ``labels_out`` (int32 memmap, same shape), and
       union provisional ids across slab faces (26-connectivity). Per-slab
       statistics (voxel counts, centroid sums, bbox extremes, background
       projections) are accumulated incrementally — O(slab + n_labels) memory.
    2. rewrite ``labels_out`` slab-by-slab through the canonical LUT.

    ``workers`` (0 = one per host core, capped at 8; 1 = serial): slab
    labeling+stats fan out over a thread pool — the reference's cc3d pass is
    single-threaded C++ (count_blobs.py:59-64); here each slab's union-find
    raster sweep is an independent GIL-releasing native call, so stage 3
    scales across the many host cores a real TPU VM has. Base assignment,
    face unions and stats concatenation stay on the caller's thread in slab
    order, so the output is BIT-identical to the serial path (provisional
    ids, union order, canonical LUT and stats are all order-preserved).
    Peak memory grows to ≤ workers+1 in-flight slabs.

    Canonical numbering matches the whole-volume engines: components ordered
    by first raster appearance (provisional ids grow in raster order, so the
    minimum provisional id in each union class is its first appearance).

    Returns (n_components, stats) where stats has the cc3d-compatible layout
    of ``component_statistics`` (row 0 = background).
    """
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    if label_fn is None:
        from delivr_cfos_tpu_torch.native.cc import cc_label_native

        def label_fn(vol):
            native = cc_label_native(vol)
            return native if native is not None else label_volume_host(vol)

    Z, Y, X = binary.shape
    assert labels_out.shape == binary.shape
    # look-ahead label workers read `binary` slabs while earlier slabs'
    # offset-writes land in `labels_out`; aliased buffers would corrupt
    # those reads (the serial path was read-before-write safe)
    if isinstance(binary, np.ndarray) and isinstance(labels_out, np.ndarray):
        assert not np.may_share_memory(binary, labels_out), (
            "binary and labels_out must not alias"
        )
    uf = _UnionFind()
    next_base = 1
    prev_last_plane = None
    # per-provisional-id accumulators (lists indexed by provisional id - 1)
    counts_parts = []
    csum_parts = []  # (n_loc, 3) float64 sums of (z, y, x), z in global coords
    bbox_parts = []  # (n_loc, 6) int64 (zmin, zmax, ymin, ymax, xmin, xmax)
    bg_any_z = np.zeros(Z, bool)
    bg_any_y = np.zeros(Y, bool)
    bg_any_x = np.zeros(X, bool)
    slab_bounds = [
        (z0, min(z0 + slab_planes, Z)) for z0 in range(0, Z, slab_planes)
    ]

    w = workers if workers > 0 else min(8, _os.cpu_count() or 1)
    w = min(w, len(slab_bounds))
    pool = ThreadPoolExecutor(max_workers=w) if w > 1 else None
    write_futs = []
    label_futs = {}

    def _take_local(k: int):
        if pool is None:
            return _slab_local_label_stats(binary, *slab_bounds[k], label_fn)
        # bounded look-ahead: keep ≤ w+1 label jobs in flight
        hi = min(k + w + 1, len(slab_bounds))
        for j in range(k, hi):
            if j not in label_futs:
                label_futs[j] = pool.submit(
                    _slab_local_label_stats, binary, *slab_bounds[j], label_fn
                )
        return label_futs.pop(k).result()

    try:
        for k, (z0, z1) in enumerate(slab_bounds):
            lab, n_loc, cnt, cs, bb, bg_proj = _take_local(k)
            base = next_base - 1
            # face planes in GLOBAL ids (copies: `lab` is offset in place by
            # the write job below, possibly on a worker thread)
            first_plane = lab[0].copy()
            first_plane[first_plane > 0] += base
            last_plane = lab[-1].copy()
            last_plane[last_plane > 0] += base

            def _offset_write(lab=lab, base=base, z0=z0, z1=z1):
                lab[lab > 0] += base
                labels_out[z0:z1] = lab

            if pool is None:
                _offset_write()
            else:
                write_futs.append(pool.submit(_offset_write))

            if prev_last_plane is not None:
                _union_faces(uf, prev_last_plane, first_plane)
            prev_last_plane = last_plane

            counts_parts.append(cnt)
            csum_parts.append(cs)
            bbox_parts.append(bb)
            bg_any_z[z0:z1] |= bg_proj[0]
            bg_any_y |= bg_proj[1]
            bg_any_x |= bg_proj[2]
            next_base += n_loc
        for f in write_futs:
            f.result()
    except BaseException:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        raise

    total_prov = next_base - 1
    counts_prov = (
        np.concatenate(counts_parts) if counts_parts else np.zeros(0, np.int64)
    )
    csums_prov = (
        np.concatenate(csum_parts) if csum_parts else np.zeros((0, 3), np.float64)
    )
    bbox_prov = (
        np.concatenate(bbox_parts) if bbox_parts else np.zeros((0, 6), np.int64)
    )

    # canonical remap. The union-find always keeps the smallest id as root
    # (_UnionFind.union), so every class root IS its min provisional id, and
    # ascending root order == first-raster-appearance order. Only ids that
    # were ever merged live in uf.parent; everything else is its own root.
    roots_of = np.arange(total_prov + 1, dtype=np.int64)
    for k in list(uf.parent):
        roots_of[k] = uf.find(k)
    uniq_roots = np.unique(roots_of[1:]) if total_prov else np.zeros(0, np.int64)
    n = int(uniq_roots.size)
    lut = np.zeros(total_prov + 1, np.int32)
    if total_prov:
        lut[1:] = np.searchsorted(uniq_roots, roots_of[1:]).astype(np.int32) + 1

    # pass 2: rewrite labels through the LUT (slabs disjoint → embarrassingly
    # parallel; LUT gather + memmap copy both release the GIL)
    def _rewrite(b):
        z0, z1 = b
        chunk = np.asarray(labels_out[z0:z1])
        labels_out[z0:z1] = lut[chunk]

    if pool is None:
        for b in slab_bounds:
            _rewrite(b)
    else:
        try:
            list(pool.map(_rewrite, slab_bounds))
        finally:
            pool.shutdown(wait=True)

    # merge statistics into canonical ids
    counts = np.zeros(n + 1, np.int64)
    csums = np.zeros((n + 1, 3), np.float64)
    bboxes = np.zeros((n + 1, 6), np.int64)
    bboxes[:, 0::2] = np.iinfo(np.int64).max
    bboxes[:, 1::2] = -1
    ids = lut[1:]  # canonical id of each provisional id
    np.add.at(counts, ids, counts_prov)
    np.add.at(csums, ids, csums_prov)
    for axis in range(3):
        np.minimum.at(bboxes[:, 2 * axis], ids, bbox_prov[:, 2 * axis])
        np.maximum.at(bboxes[:, 2 * axis + 1], ids, bbox_prov[:, 2 * axis + 1])
    bboxes[bboxes[:, 1] < 0] = 0

    centroids = np.full((n + 1, 3), np.nan, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        centroids[1:] = csums[1:] / counts[1:, None].astype(np.float64)

    counts[0] = Z * Y * X - counts[1:].sum()
    if counts[0] > 0:
        grid_sums = np.array(
            [
                Y * X * Z * (Z - 1) / 2.0,
                Z * X * Y * (Y - 1) / 2.0,
                Z * Y * X * (X - 1) / 2.0,
            ]
        )
        centroids[0] = (grid_sums - csums[1:].sum(axis=0)) / counts[0]
        for axis, proj in ((0, bg_any_z), (1, bg_any_y), (2, bg_any_x)):
            idx = np.nonzero(proj)[0]
            bboxes[0, 2 * axis] = idx[0]
            bboxes[0, 2 * axis + 1] = idx[-1]

    stats = {
        "voxel_counts": counts,
        "centroids": centroids,
        "bounding_boxes": bboxes,
    }
    return n, stats


def label_slabs_streaming(slab_iter, label_fn=label_volume_host):
    """Label a volume delivered as consecutive z-slabs.

    ``slab_iter`` yields (z_offset, slab uint8). Yields (z_offset,
    labels int64 with globally-unique provisional ids) after consuming the
    whole stream; returns the final relabeling LUT via the second element.

    Returns (list of (z_offset, provisional_labels), remap dict, n_components).
    26-connectivity across faces: voxels on the last plane of slab k connect
    to any of the 9 neighbors on the first plane of slab k+1.
    """
    uf = _UnionFind()
    slabs = []
    next_base = 1
    prev_last_plane = None
    prev_offset = None
    for z_off, slab in slab_iter:
        labels, n = label_fn(slab)
        glob = labels.astype(np.int64)
        glob[glob > 0] += next_base - 1
        if prev_last_plane is not None:
            first = glob[0]
            # 26-connectivity between consecutive planes: 3×3 neighborhood
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    a = prev_last_plane
                    b = first
                    ay0, ay1 = max(dy, 0), a.shape[0] + min(dy, 0)
                    ax0, ax1 = max(dx, 0), a.shape[1] + min(dx, 0)
                    by0, by1 = max(-dy, 0), b.shape[0] + min(-dy, 0)
                    bx0, bx1 = max(-dx, 0), b.shape[1] + min(-dx, 0)
                    av = a[ay0:ay1, ax0:ax1]
                    bv = b[by0:by1, bx0:bx1]
                    both = (av > 0) & (bv > 0)
                    if both.any():
                        pairs = np.unique(
                            np.stack([av[both], bv[both]], axis=1), axis=0
                        )
                        for pa, pb in pairs:
                            uf.union(int(pa), int(pb))
        slabs.append((z_off, glob))
        next_base += n
        prev_last_plane = glob[-1]
        prev_offset = z_off
    # canonical remap: roots sorted by first (provisional) appearance
    roots = {}
    for _, glob in slabs:
        for v in np.unique(glob):
            if v > 0:
                r = uf.find(int(v))
                if r not in roots or v < roots[r]:
                    roots.setdefault(r, v)
    ordered = sorted(roots, key=lambda r: roots[r])
    final = {r: i + 1 for i, r in enumerate(ordered)}
    remap = {}
    for _, glob in slabs:
        for v in np.unique(glob):
            if v > 0:
                remap[int(v)] = final[uf.find(int(v))]
    return slabs, remap, len(ordered)


def apply_remap(labels: np.ndarray, remap: dict) -> np.ndarray:
    if not remap:
        return labels.astype(np.int32)
    max_v = max(remap)
    lut = np.zeros(max_v + 1, np.int32)
    for k, v in remap.items():
        lut[k] = v
    out = np.zeros(labels.shape, np.int32)
    fg = labels > 0
    out[fg] = lut[labels[fg]]
    return out


# --------------------------------------------------------------------------
# statistics (cc3d.statistics equivalent)
# --------------------------------------------------------------------------


def component_statistics_streaming(labels, n: int, slab_planes: int = 64) -> dict:
    """``component_statistics`` over an out-of-core (memmapped) canonical
    label volume: one z-slab pass, O(slab + n) memory. Same cc3d-compatible
    output layout (row 0 = background, incl. analytic background centroid
    and projection-based background bbox)."""
    Z, Y, X = labels.shape
    counts = np.zeros(n + 1, np.int64)
    csums = np.zeros((n + 1, 3), np.float64)
    bboxes = np.zeros((n + 1, 6), np.int64)
    bboxes[:, 0::2] = np.iinfo(np.int64).max
    bboxes[:, 1::2] = -1
    bg_any = [np.zeros(Z, bool), np.zeros(Y, bool), np.zeros(X, bool)]

    for z0 in range(0, Z, slab_planes):
        z1 = min(z0 + slab_planes, Z)
        lab = np.asarray(labels[z0:z1])
        fg = lab > 0
        vals = lab[fg]
        zz, yy, xx = np.nonzero(fg)
        counts += np.bincount(vals, minlength=n + 1).astype(np.int64)
        if vals.size:
            csums[:, 0] += np.bincount(vals, weights=zz + z0, minlength=n + 1)
            csums[:, 1] += np.bincount(vals, weights=yy, minlength=n + 1)
            csums[:, 2] += np.bincount(vals, weights=xx, minlength=n + 1)
            for axis, coords, off in ((0, zz, z0), (1, yy, 0), (2, xx, 0)):
                np.minimum.at(bboxes[:, 2 * axis], vals, coords + off)
                np.maximum.at(bboxes[:, 2 * axis + 1], vals, coords + off)
        bg = ~fg
        if bg.any():
            bg_any[0][z0:z1] |= bg.any(axis=(1, 2))
            bg_any[1] |= bg.any(axis=(0, 2))
            bg_any[2] |= bg.any(axis=(0, 1))

    bboxes[bboxes[:, 1] < 0] = 0
    centroids = np.full((n + 1, 3), np.nan, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        centroids[1:] = csums[1:] / counts[1:, None].astype(np.float64)
    counts[0] = Z * Y * X - counts[1:].sum()
    if counts[0] > 0:
        grid_sums = np.array(
            [
                Y * X * Z * (Z - 1) / 2.0,
                Z * X * Y * (Y - 1) / 2.0,
                Z * Y * X * (X - 1) / 2.0,
            ]
        )
        centroids[0] = (grid_sums - csums[1:].sum(axis=0)) / counts[0]
        for axis in range(3):
            idx = np.nonzero(bg_any[axis])[0]
            bboxes[0, 2 * axis] = idx[0]
            bboxes[0, 2 * axis + 1] = idx[-1]
    return {
        "voxel_counts": counts,
        "centroids": centroids,
        "bounding_boxes": bboxes,
    }


def component_statistics(labels: np.ndarray, n: int) -> dict:
    """voxel_counts, centroids (z, y, x float64), bounding_boxes per label
    1..n, matching ``cc3d.statistics(..., no_slice_conversion=True)`` fields.
    ``voxel_counts[0]``/row 0 refer to background, like cc3d."""
    flat = labels.ravel()
    counts = np.bincount(flat[flat >= 0], minlength=n + 1).astype(np.int64)
    Z, Y, X = labels.shape
    zz, yy, xx = np.nonzero(labels > 0)
    vals = labels[zz, yy, xx]
    centroids = np.full((n + 1, 3), np.nan, np.float64)
    fg_sums = np.zeros(3)
    if vals.size:
        sz = np.bincount(vals, weights=zz, minlength=n + 1)
        sy = np.bincount(vals, weights=yy, minlength=n + 1)
        sx = np.bincount(vals, weights=xx, minlength=n + 1)
        c = counts.astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            centroids[:, 0] = sz / c
            centroids[:, 1] = sy / c
            centroids[:, 2] = sx / c
        fg_sums = np.array([sz[1:].sum(), sy[1:].sum(), sx[1:].sum()])
    if counts[0] > 0:
        # background centroid (cc3d computes it; reference blob_depthmap.py:196
        # iterates from cc_id 0): analytic grid sums minus foreground sums
        grid_sums = np.array(
            [
                Y * X * Z * (Z - 1) / 2.0,
                Z * X * Y * (Y - 1) / 2.0,
                Z * Y * X * (X - 1) / 2.0,
            ]
        )
        centroids[0] = (grid_sums - fg_sums) / counts[0]
    # bounding boxes: (zmin, zmax, ymin, ymax, xmin, xmax) inclusive
    bboxes = np.zeros((n + 1, 6), np.int64)
    if vals.size:
        for axis, coords in enumerate((zz, yy, xx)):
            mins = np.full(n + 1, np.iinfo(np.int64).max)
            maxs = np.full(n + 1, -1)
            np.minimum.at(mins, vals, coords)
            np.maximum.at(maxs, vals, coords)
            bboxes[:, 2 * axis] = np.where(counts > 0, mins, 0)
            bboxes[:, 2 * axis + 1] = np.where(counts > 0, maxs, 0)
    if counts[0] > 0:
        # background bbox from per-axis any(labels == 0) projections
        bg = labels == 0
        for axis in range(3):
            other = tuple(a for a in range(3) if a != axis)
            has = np.any(bg, axis=other)
            idx = np.nonzero(has)[0]
            bboxes[0, 2 * axis] = idx[0]
            bboxes[0, 2 * axis + 1] = idx[-1]
    return {
        "voxel_counts": counts,
        "centroids": centroids,
        "bounding_boxes": bboxes,
    }
