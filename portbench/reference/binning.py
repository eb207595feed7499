"""Plain reference of hybrid-feature binning (NumPy, vectorised).

The semantics the binned table must have, worked out again from the raw
columns: a value that reads as a number is numeric, any other non-missing
value is a category, ``None`` and NaN are missing.  Per feature:

* numeric bins: the sorted unique values when there are at most
  ``max_num_bins`` of them, else the unique "nearest" quantiles at
  ``max_num_bins`` evenly spaced levels, with the largest value appended
  when the quantiles miss it; a value takes the first edge >= itself
  (clamped to the last numeric bin);
* categorical bins follow the numeric ones, in order of first appearance;
* one missing bin after them.

``n_bins`` is the widest feature's bin count.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["bin_columns"]


def _parse(col):
    """``(numeric float64 with NaN elsewhere, category codes -1 elsewhere,
    category values in first-appearance order)``."""
    arr = np.asarray(col)
    if arr.dtype != object:
        num = arr.astype(np.float64)
        return num, np.full(num.shape, -1, np.int64), []
    uniq, first, inv = np.unique(arr.astype(str), return_index=True,
                                 return_inverse=True)
    as_num = np.full(len(uniq), np.nan)
    is_cat = np.zeros(len(uniq), bool)
    for i, j in enumerate(first):
        v = arr[j]
        if v is None or (isinstance(v, float) and math.isnan(v)):
            continue
        try:
            as_num[i] = float(v)
        except (TypeError, ValueError):
            is_cat[i] = True
    order = [i for i in np.argsort(first, kind="stable") if is_cat[i]]
    local = np.full(len(uniq), -1, np.int64)
    local[order] = np.arange(len(order))
    return as_num[inv], local[inv], [arr[first[i]] for i in order]


def _edges(vals, max_num_bins):
    uniq = np.unique(vals)
    if uniq.size <= max_num_bins:
        return uniq
    edges = np.unique(np.quantile(vals, np.linspace(0.0, 1.0, max_num_bins),
                                  method="nearest"))
    if edges[-1] < uniq[-1]:
        edges = np.append(edges, uniq[-1])
    return edges


def bin_columns(columns, max_num_bins: int):
    """``(bins [M, K] int32, n_num [K] int32, n_cat [K] int32, n_bins)``."""
    out, n_num, n_cat = [], [], []
    for col in columns:
        num, cat, cats = _parse(col)
        numeric = ~np.isnan(num)
        edges = (_edges(num[numeric], max_num_bins) if numeric.any()
                 else np.zeros(0))
        b = np.full(num.shape, edges.size + len(cats), np.int64)
        if edges.size:
            b[numeric] = np.minimum(np.searchsorted(edges, num[numeric]),
                                    edges.size - 1)
        b[cat >= 0] = edges.size + cat[cat >= 0]
        out.append(b.astype(np.int32))
        n_num.append(edges.size)
        n_cat.append(len(cats))
    n_num = np.asarray(n_num, np.int32)
    n_cat = np.asarray(n_cat, np.int32)
    return (np.stack(out, axis=1), n_num, n_cat,
            int((n_num + n_cat + 1).max()))
