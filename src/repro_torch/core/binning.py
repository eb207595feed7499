"""Host-side binning (numpy), the port's copy of ``repro.core.binning``.

The paper sorts each feature's numerical values once (O(K M log M)) and
filters the sorted lists down the tree.  The builder instead *bins* each
feature once: numerical values map to quantile (or exact unique-value) bins,
categorical values map to hashed ids, and every feature gets one extra
"missing / other-type" bin.  Bin ids are int32 and never change during tree
construction, so the whole build works on a dense ``[M, K] int32`` tensor.

Unified bin layout per feature ``k`` (paper's hybrid-feature semantics):

    [0, n_num_k)                 numeric bins, ordered   ("<=" / ">" splits)
    [n_num_k, n_num_k+n_cat_k)   categorical bins        ("=" splits)
    n_num_k + n_cat_k            missing / other-type    (never positive)

Cross-type comparison semantics (paper Table 3) fall out of the layout: a
categorical bin id is never ``< n_num`` so it fails every numeric predicate;
the missing bin id never equals a categorical candidate so it fails every
equality predicate.  No pre-encoding (one-hot / integer ordering) is imposed.

This module is pure numpy and must stay byte-for-byte equivalent in
behaviour to the JAX package's copy (tests/test_torch_binning.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np

__all__ = [
    "FeatureMeta", "BinnedTable", "fit_bins", "transform", "parse_column",
    "fit_label_classes",
]

_MISSING = object()


@dataclasses.dataclass
class FeatureMeta:
    name: str
    n_num: int                     # number of numeric bins
    n_cat: int                     # number of categorical bins
    edges: np.ndarray              # (n_num,) right-inclusive upper edges
    cats: dict                     # raw categorical value -> local cat id
    exact: bool                    # True if edges == the unique numeric values

    @property
    def missing_bin(self) -> int:
        return self.n_num + self.n_cat

    @property
    def n_bins(self) -> int:
        return self.n_num + self.n_cat + 1

    def threshold_value(self, b: int) -> float:
        """Human-readable numeric threshold for split ``<= bin b``."""
        return float(self.edges[b]) if self.n_num else math.nan

    def category_value(self, b: int) -> Any:
        local = b - self.n_num
        for v, i in self.cats.items():
            if i == local:
                return v
        return None


@dataclasses.dataclass
class BinnedTable:
    bins: np.ndarray               # [M, K] int32
    n_num: np.ndarray              # [K] int32
    n_cat: np.ndarray              # [K] int32
    metas: list                    # list[FeatureMeta]
    n_bins: int                    # global B = max_k metas[k].n_bins

    @property
    def shape(self):
        return self.bins.shape


def parse_column(col: Sequence[Any]):
    """Parse one raw column per the paper's hybrid-feature rule.

    Each value is read as a number first; if the conversion fails it is a
    categorical value; ``None``/NaN are missing.  Returns
    ``(numeric float64 array with NaN where non-numeric, list of raw
    categorical values aligned with rows or _MISSING/None)``.
    """
    m = len(col)
    num = np.full(m, np.nan, dtype=np.float64)
    cat = [None] * m
    arr = np.asarray(col, dtype=object)
    for i, v in enumerate(arr):
        if v is None:
            cat[i] = _MISSING
            continue
        if isinstance(v, (int, float, np.integer, np.floating)):
            if isinstance(v, (float, np.floating)) and math.isnan(float(v)):
                cat[i] = _MISSING
            else:
                num[i] = float(v)
            continue
        # string / other: try numeric parse first (paper: read as number,
        # convert to categorical if the conversion fails)
        try:
            num[i] = float(v)
        except (TypeError, ValueError):
            cat[i] = v
    return num, cat


def _numeric_edges(vals: np.ndarray, max_num_bins: int):
    """Right-inclusive bin edges; exact when #unique <= max_num_bins."""
    uniq = np.unique(vals)            # sorted
    if uniq.size <= max_num_bins:
        return uniq, True
    # quantile edges over the *examples* (weighted by frequency, like
    # XGBoost-hist); always keep the max so transform never overflows.
    qs = np.linspace(0.0, 1.0, max_num_bins)
    edges = np.unique(np.quantile(vals, qs, method="nearest"))
    if edges[-1] < uniq[-1]:
        edges = np.append(edges, uniq[-1])
    return edges.astype(np.float64), False


def _fit_feature(col, name: str, max_num_bins: int) -> FeatureMeta:
    num, cat = parse_column(col)
    numeric_mask = ~np.isnan(num)
    if numeric_mask.any():
        edges, exact = _numeric_edges(num[numeric_mask], max_num_bins)
    else:
        edges, exact = np.zeros(0, dtype=np.float64), True
    cats: dict = {}
    for v in cat:
        if v is None or v is _MISSING:
            continue
        if v not in cats:
            cats[v] = len(cats)
    return FeatureMeta(name=name, n_num=int(edges.size), n_cat=len(cats),
                       edges=edges, cats=cats, exact=exact)


def _transform_feature(col, meta: FeatureMeta) -> np.ndarray:
    num, cat = parse_column(col)
    m = len(col)
    out = np.full(m, meta.missing_bin, dtype=np.int32)
    numeric_mask = ~np.isnan(num)
    if meta.n_num and numeric_mask.any():
        # bin b covers (edges[b-1], edges[b]]; values above the last edge are
        # out-of-range at inference time -> clamp to the last numeric bin.
        idx = np.searchsorted(meta.edges, num[numeric_mask], side="left")
        idx = np.minimum(idx, meta.n_num - 1)
        out[numeric_mask] = idx.astype(np.int32)
    elif numeric_mask.any():
        # numeric value in a feature that trained with no numeric values:
        # other-type -> missing bin (already set)
        pass
    for i, v in enumerate(cat):
        if v is None or v is _MISSING:
            continue
        local = meta.cats.get(v)
        if local is not None:
            out[i] = meta.n_num + local
        # unseen category -> missing/other bin (already set)
    return out


def fit_bins(columns: Sequence[Sequence[Any]], max_num_bins: int = 256,
             names: Sequence[str] | None = None) -> BinnedTable:
    """Fit bins on raw columns and transform them.  ``columns`` is a list of
    K columns, each of length M, possibly containing mixed numeric /
    categorical / missing values (the paper's hybrid features)."""
    k = len(columns)
    names = names or [f"f{i}" for i in range(k)]
    metas = [_fit_feature(c, names[i], max_num_bins) for i, c in enumerate(columns)]
    bins = np.stack([_transform_feature(c, m) for c, m in zip(columns, metas)], axis=1)
    return BinnedTable(
        bins=bins.astype(np.int32),
        n_num=np.asarray([m.n_num for m in metas], dtype=np.int32),
        n_cat=np.asarray([m.n_cat for m in metas], dtype=np.int32),
        metas=metas,
        n_bins=max(m.n_bins for m in metas),
    )


def transform(columns: Sequence[Sequence[Any]], table: BinnedTable) -> np.ndarray:
    """Transform new raw columns with already-fitted bins -> [M,K] int32."""
    bins = np.stack(
        [_transform_feature(c, m) for c, m in zip(columns, table.metas)], axis=1)
    return bins.astype(np.int32)


def fit_label_classes(labels: Sequence[Any]):
    """Map raw class labels to 0..C-1 (host side)."""
    classes: dict = {}
    out = np.empty(len(labels), dtype=np.int32)
    for i, v in enumerate(labels):
        if v not in classes:
            classes[v] = len(classes)
        out[i] = classes[v]
    return out, classes
