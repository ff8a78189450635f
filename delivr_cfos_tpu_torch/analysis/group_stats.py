"""Group-level statistics on region count tables.

Rebuild of the reference's offline level-analysis script
(reference: statistics/2022-03-26_level_analysis_v04.py) as a reusable,
experiment-agnostic module:

- ``hierarchical_level_sum``: accumulate per-region counts up the ontology
  tree by descending structure-level (reference :76-90), including the
  background/root parent fix (:66-68) and the overcount sanity check (:92-95)
- ``normalize_to_group_mean``: per-experiment normalization to a control
  subgroup's mean (reference :32-43)
- ``pairwise_group_tests``: two-sample t-tests per ontology level between
  groups (reference uses ``scipy.stats.ttest_ind``, :141-144) with
  Benjamini–Hochberg FDR at α=0.1 (statsmodels ``multipletests`` fdr_bh,
  :147-149 — reimplemented here, statsmodels is not in this image)

The port's copy of ``delivr_cfos_tpu/analysis/group_stats.py``, on the host.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
from scipy import stats as sp_stats


def benjamini_hochberg(pvals: np.ndarray, alpha: float = 0.1):
    """BH step-up FDR. Returns (reject bool array, adjusted p-values),
    matching statsmodels multipletests(..., method='fdr_bh')."""
    p = np.asarray(pvals, np.float64)
    n = p.shape[0]
    order = np.argsort(p)
    ranked = p[order] * n / np.arange(1, n + 1)
    adj = np.minimum.accumulate(ranked[::-1])[::-1]
    adj = np.clip(adj, 0, 1)
    out = np.empty(n, np.float64)
    out[order] = adj
    reject = out <= alpha
    return reject, out


def hierarchical_level_sum(
    region_table: pd.DataFrame, sample_cols: list
) -> tuple:
    """Sum counts up the ontology by descending structure-level.

    ``region_table`` needs columns id, parent_id, structure-level, name and
    the per-sample count columns. Returns (summed table, overcount Series) —
    the overcount is background total minus the raw per-sample sums
    (reference :92-95; positive = overcounting, caused by regions whose
    parent appears at a non-adjacent level).
    """
    cells = region_table.sort_values("structure-level", ascending=False).copy()
    cells[sample_cols] = cells[sample_cols].fillna(0.0)
    # background (iloc row with name 'background') and root point at parent 0
    cells.loc[cells["name"] == "background", "parent_id"] = 0
    cells.loc[cells["parent_acronym"] == '"root"', "parent_id"] = 0
    cells["parent_id"] = (
        pd.to_numeric(cells["parent_id"], errors="coerce").fillna(0).astype(np.int64)
    )

    for level_number in cells["structure-level"].unique():
        level = cells.loc[cells["structure-level"] == level_number]
        sums = level.groupby("parent_id")[sample_cols].sum()
        for parent, summed in sums.iterrows():
            sel = cells["id"] == parent
            if sel.any():
                cells.loc[sel, sample_cols] = cells.loc[sel, sample_cols] + summed

    bg = cells.loc[cells["name"] == "background", sample_cols]
    overcount = (
        bg.squeeze() - region_table[sample_cols].fillna(0.0).sum()
        if len(bg)
        else pd.Series(0.0, index=sample_cols)
    )
    return cells, overcount


def normalize_to_group_mean(
    df: pd.DataFrame, experiment_cols: list, control_cols: list
) -> pd.DataFrame:
    """Divide every sample column of an experiment by the control subgroup's
    per-region mean (reference :32-43). Returns a modified copy."""
    df = df.copy()
    group_avg = df[control_cols].T.mean()
    df[experiment_cols] = df[experiment_cols].div(group_avg, axis=0)
    return df


def pairwise_group_tests(
    cell_list: pd.DataFrame,
    groups: dict,
    alpha: float = 0.1,
    equal_var: bool = True,
    drop_levels_from_top: int = 2,
    verbose: bool = True,
) -> pd.DataFrame:
    """Per-level pairwise t-tests + BH FDR between sample groups.

    ``groups`` maps group name → list of sample columns. Rows with any zero
    are dropped after replacing 0 → NaN, as in the reference (:124-127).
    Levels are processed in the table's level order except the last
    ``drop_levels_from_top`` (the reference skips the two coarsest,
    :131). Returns the concatenated per-level table with
    mean/p/p-corrected columns per group pair.
    """
    cell_list = cell_list.replace(0, np.nan).dropna(axis=0, how="any")
    names = list(groups.keys())
    pairs = [
        (a, b) for i, a in enumerate(names) for b in names[i + 1 :]
    ]
    out_levels = []
    levels = cell_list["structure-level"].unique()
    levels = levels[: len(levels) - drop_levels_from_top] if drop_levels_from_top else levels
    for level_number in levels:
        level = cell_list.loc[cell_list["structure-level"] == level_number].copy()
        if not len(level):
            continue
        for g, cols in groups.items():
            level[f"{g}_mean"] = level[cols].mean(axis=1)
        for a, b in pairs:
            t, p = sp_stats.ttest_ind(
                level[groups[a]], level[groups[b]], axis=1, equal_var=equal_var
            )
            level[f"p_{a}_vs_{b}"] = p
            ok = np.isfinite(p)
            adj = np.full(len(p), np.nan)
            rej = np.zeros(len(p), bool)
            if ok.any():
                rej_ok, adj_ok = benjamini_hochberg(p[ok], alpha)
                adj[ok] = adj_ok
                rej[ok] = rej_ok
            level[f"pvals_corrected_{a}_vs_{b}"] = adj
            if verbose and rej.any():
                regions = level.loc[rej, "acronym"].values.tolist()
                print(
                    f"found a significant difference at level {level_number} "
                    f"{a} vs {b}! regions: {regions}"
                )
        out_levels.append(level)
    if not out_levels:
        return pd.DataFrame(columns=cell_list.columns)
    return pd.concat(out_levels, axis=0)


def level_analysis(
    region_table: pd.DataFrame,
    groups: dict,
    control_group: str | None = None,
    alpha: float = 0.1,
    equal_var: bool = True,
    drop_levels_from_top: int = 2,
) -> dict:
    """End-to-end analysis mirroring the reference script: hierarchical sum →
    optional control normalization → per-level tests. Returns
    {"collapsed": df, "overcount": Series, "stats": df}."""
    sample_cols = [c for cols in groups.values() for c in cols]
    collapsed, overcount = hierarchical_level_sum(region_table, sample_cols)
    if control_group is not None:
        collapsed = normalize_to_group_mean(
            collapsed, sample_cols, groups[control_group]
        )
    stats_df = pairwise_group_tests(
        collapsed,
        groups,
        alpha=alpha,
        equal_var=equal_var,
        drop_levels_from_top=drop_levels_from_top,
    )
    return {"collapsed": collapsed, "overcount": overcount, "stats": stats_df}
