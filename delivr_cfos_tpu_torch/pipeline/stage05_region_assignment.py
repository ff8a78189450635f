"""Stage 5 — Allen-CCF3 region assignment, count tables, heatmaps.

The counterpart of ``delivr_cfos_tpu/pipeline/stage05_region_assignment.py``
(reference: cells_to_atlas.py:243-343), with the same output contract per
mouse in {region_output}, byte for byte:

    cells_{mouse}.csv              per-cell rows + joined ontology columns
    cells_overview_{mouse}.csv     per-region count table (graph_order sorted)
    region_collapsed_{mouse}.csv   color-group-collapsed table
    heatmap_{mouse}.tif            σ=2.25 Gaussian-blurred count volume
and at the end:
    region_overview.xlsx, region_collapsed_overview.xlsx,
    heatmap_collection.pickledump

The tables are pandas on the host, as in the JAX package. The heatmap, the
one pass that grows with the data (a 25 µm CCF3 grid of 77 M voxels, 308 MB
of float32 per brain), is built on ``device`` (``ops/gaussian.py``: the
counts and scipy's blur, to scipy's bits) and copied back once for the TIFF
and the pickle.

Coordinate chain (reference mbrainaligner_atlas_to_ccf, :114-151): 50 µm
mBrainAligner space → flip x (264−x), flip y (160−y), swap x/y, ×2 → 25 µm
CCF3 voxel indices, round to int, drop out-of-bounds. The annotation volume
stores graph_order values; region lookup adds +1 except for background
(two graph_order-0 rows: background + root; reference :211-218).
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
import pandas as pd

from delivr_cfos_tpu_torch.analysis.ontology import parse_ontology_xml
from delivr_cfos_tpu_torch.config import PipelineConfig
from delivr_cfos_tpu_torch.ops.gaussian import gaussian_filter_reflect, scatter_counts
from delivr_cfos_tpu_torch.utils.device import StepSeconds, resolve_device
from delivr_cfos_tpu_torch.utils.hooks import HookEmitter
from delivr_cfos_tpu_torch.utils.io.tiff import read_tiff, write_tiff_stack
from delivr_cfos_tpu_torch.utils.io.xlsx import write_xlsx
from delivr_cfos_tpu_torch.utils.logging import log

HEATMAP_SIGMA = 2.25  # reference: cells_to_atlas.py:196


def mbrainaligner_atlas_to_ccf(cells: pd.DataFrame, label_shape) -> pd.DataFrame:
    """50 µm mBrainAligner coords → 25 µm CCF3 voxel indices
    (reference: cells_to_atlas.py:114-151)."""
    cells = cells.copy()
    cells["x"] = 264 - cells["x"]
    cells["y"] = 160 - cells["y"]
    cells = cells.rename(columns={"x": "y", "y": "x"})
    cells[["x", "y", "z"]] = cells[["x", "y", "z"]] * 2
    cells["connected_component_id"] += 1  # blob ids start at 1 (reference :138)
    cells = cells.round().astype(int)
    n0 = len(cells)
    cells = cells[
        (cells.x >= 0)
        & (cells.x < label_shape[2])
        & (cells.y >= 0)
        & (cells.y < label_shape[1])
        & (cells.z >= 0)
        & (cells.z < label_shape[0])
    ].reset_index(drop=True)
    log("discarded out of bounds cells:", n0 - len(cells))
    return cells


def cells_to_atlas(cells: pd.DataFrame, label_image: np.ndarray, ontology_df: pd.DataFrame):
    """Region lookup per cell + ontology join (reference: cells_to_atlas.py:202-225)."""
    region = label_image[
        cells["z"].to_numpy(), cells["y"].to_numpy(), cells["x"].to_numpy()
    ].astype(np.int64)
    region[region != 0] += 1  # +1 graph_order offset except background
    allvals = ontology_df.iloc[region].reset_index(drop=False)
    return cells.merge(allvals, left_index=True, right_index=True), allvals


def create_region_table(cells: pd.DataFrame, ontology_df: pd.DataFrame) -> pd.DataFrame:
    """Per-region counts ordered by graph_order (reference: cells_to_atlas.py:153-172)."""
    table = ontology_df.set_index("graph_order")
    table["number"] = cells["graph_order"].value_counts()
    table = table.reset_index()
    table = table.reindex(
        columns=[
            "id",
            "number",
            "name",
            "acronym",
            "red",
            "green",
            "blue",
            "graph_order",
            "parent_id",
            "parent_acronym",
            "color-hex-triplet",
            "structure-level",
        ]
    )
    table["graph_order"] = table["graph_order"].astype(int)
    table = table.sort_values(by=["graph_order"])
    table["number"] = table["number"].fillna(0)
    return table


def collapse_to_color_group(elements, ontology_df: pd.DataFrame) -> pd.DataFrame:
    """Collapse counts by color-hex group (reference: cells_to_atlas.py:92-112).

    One groupby per input instead of the reference's O(groups × regions)
    row-wise scan; column contracts preserved exactly: ColorGroup rows in
    first-appearance ontology order, GroupedAcronyms joined in ontology row
    order, GroupName/GroupAcronym from the group's first acronym (GroupName
    through the reference's acronym→name ``to_string`` lookup, which
    concatenates when an acronym recurs in the ontology), BlobCount summed
    over the element rows of that color (0 when absent or no elements).
    """
    tmp = pd.DataFrame(elements)
    by_color = ontology_df.groupby("color-hex-triplet", sort=False)
    colors = ontology_df["color-hex-triplet"].unique()
    grouped_acronyms = by_color["acronym"].agg(", ".join)
    first_acronym = by_color["acronym"].first()
    # acronym→name through the reference's ``to_string`` lookup, evaluated
    # only for the acronyms that lead a group (to_string is ~1 ms a call)
    name_of_acronym = (
        ontology_df[ontology_df["acronym"].isin(first_acronym)]
        .groupby("acronym", sort=False)["name"]
        .agg(lambda s: s.to_string(index=False).strip())
    )
    if len(tmp):
        counts = tmp.groupby("color-hex-triplet")["number"].sum()
        blob_counts = [
            counts.get(c, tmp["number"].iloc[:0].sum()) for c in colors
        ]
    else:
        blob_counts = [0] * len(colors)
    groups = pd.DataFrame(
        {
            "ColorGroup": colors,
            "GroupName": name_of_acronym.loc[
                first_acronym.loc[colors]
            ].to_numpy(),
            "GroupAcronym": first_acronym.loc[colors].to_numpy(),
            "GroupedAcronyms": grouped_acronyms.loc[colors].to_numpy(),
            "BlobCount": blob_counts,
        },
        columns=[
            "ColorGroup",
            "GroupName",
            "GroupAcronym",
            "GroupedAcronyms",
            "BlobCount",
        ],
    )
    return groups


def create_heatmap(cells: pd.DataFrame, label_shape, device) -> np.ndarray:
    """Per-voxel counts blurred with σ=2.25 (reference: cells_to_atlas.py:174-200),
    computed on ``device``; returns the host float32 volume."""
    counts = scatter_counts(
        label_shape,
        cells["z"].to_numpy(int),
        cells["y"].to_numpy(int),
        cells["x"].to_numpy(int),
        device,
    )
    return gaussian_filter_reflect(counts, HEATMAP_SIGMA).cpu().numpy()


def map_cells_to_atlas(cfg: PipelineConfig, hooks: HookEmitter | None = None,
                       device=None) -> dict:
    """Stage 5 over every brain of ``cfg.raw_location``, the heatmaps on
    ``device`` (None: the card; raises where there is none). Returns the
    seconds by step."""
    dev = resolve_device(device)
    timer = StepSeconds(dev)
    ra = cfg.region_assignment
    source_folder = cfg.atlas_alignment.collection_folder
    target_folder = ra.output_location
    os.makedirs(target_folder, exist_ok=True)

    with timer.step("read_atlas"):
        ontology_df = parse_ontology_xml(ra.CCF3_ontology)
        label_image = read_tiff(ra.CCF3_atlasfile)
    min_size = cfg.postprocessing.min_size
    max_size = cfg.postprocessing.max_size

    mouse_name_list = sorted(os.listdir(cfg.raw_location))

    collection_region_table = ontology_df.copy()
    collection_collapsed_table = collapse_to_color_group(
        pd.DataFrame(columns=["id", "number"] + ontology_df.columns[2:].tolist()),
        ontology_df,
    )
    heatmap_collection = {}

    for mouse_i, mouse_name in enumerate(mouse_name_list):
        if hooks is not None:
            hooks.item(mouse_i, len(mouse_name_list))
        matches = [
            p
            for p in glob.glob(os.path.join(source_folder, mouse_name + "*"))
            if p.endswith(".csv")
        ]
        if not matches:
            log("No collection CSV for", mouse_name, "— skipping")
            continue
        with timer.step("tables"):
            cells = pd.read_csv(
                matches[0], sep=" ", usecols=["n", "x", "y", "z", "Size"],
                comment="#",  # stage 4 stamps '# registration_mode: ...'
            )
            if min_size != -1:
                cells = cells[cells["Size"] >= min_size]
            if max_size != -1:
                cells = cells[cells["Size"] <= max_size]
            cells = cells.rename(columns={"n": "connected_component_id"})

            cells = mbrainaligner_atlas_to_ccf(cells, label_image.shape)
            cells, _ = cells_to_atlas(cells, label_image, ontology_df)
            cells.to_csv(os.path.join(target_folder, f"cells_{mouse_name}.csv"))

            uniquetable = create_region_table(cells, ontology_df)
            uniquetable.to_csv(
                os.path.join(target_folder, f"cells_overview_{mouse_name}.csv")
            )
            # add to the collection (reference add_to_collection :228-240)
            reindexed = uniquetable.set_index("id").reindex(
                index=collection_region_table["id"]
            )
            collection_region_table[mouse_name] = reindexed.reset_index()["number"]

            color_table = collapse_to_color_group(uniquetable, ontology_df)
            color_table.to_csv(
                os.path.join(target_folder, f"region_collapsed_{mouse_name}.csv")
            )
            collection_collapsed_table = collection_collapsed_table.merge(
                color_table["BlobCount"].rename(mouse_name),
                left_index=True,
                right_index=True,
                how="left",
            )

        with timer.step("heatmap"):
            heatmap = create_heatmap(cells, label_image.shape, dev)
        with timer.step("write_heatmap"):
            write_tiff_stack(
                os.path.join(target_folder, f"heatmap_{mouse_name}.tif"),
                heatmap,
                compress=True,
            )
        heatmap_collection[mouse_name] = heatmap
        log("Mouse", mouse_name, "region table and heatmap generated")

    with timer.step("write_collection"):
        collection_region_table = collection_region_table.fillna(0)
        write_xlsx(
            os.path.join(target_folder, "region_overview.xlsx"),
            {"Sheet1": collection_region_table},
        )
        collection_collapsed_table = collection_collapsed_table.fillna(0)
        write_xlsx(
            os.path.join(target_folder, "region_collapsed_overview.xlsx"),
            {"Sheet1": collection_collapsed_table},
        )
        with open(os.path.join(target_folder, "heatmap_collection.pickledump"), "wb") as f:
            pickle.dump(heatmap_collection, f)
    return dict(timer)
