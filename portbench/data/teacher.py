"""Binned binary-classification data made on the device: Higgs-shaped.

The rule is that of the repository's random-tree teacher
(``make_classification``: a random axis-aligned tree labels the rows, one
random feature per node, its threshold at a uniform quantile in [0.25,
0.75]), written here for bin codes on the card so that ten million rows
take milliseconds.  Every feature is a quantile-binned continuous column,
so its codes are uniform over ``0 .. n_codes - 1`` and the q-quantile of a
node is code ``q * n_codes``.

The teacher's structure (features, thresholds, leaf log-odds) is drawn from
a fixed seed, the same for every run; ``seed`` draws the rows and the label
noise.  So every seed carries the same problem at the same size, and the
work a fit does varies little from seed to seed.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_binned", "TEACHER_SEED"]

TEACHER_SEED = 2017


def _teacher(n_features: int, n_codes: int, depth: int, base_logit: float,
             logit_scale: float):
    rng = np.random.default_rng(TEACHER_SEED)
    n_inner = (1 << depth) - 1
    feat = rng.integers(0, n_features, size=n_inner)
    thr = np.floor(rng.uniform(0.25, 0.75, size=n_inner) * n_codes)
    leaf_logit = base_logit + logit_scale * rng.normal(size=1 << depth)
    return feat, thr.astype(np.int64), leaf_logit


def make_binned(m: int, n_features: int, n_codes: int, *, depth: int,
                base_logit: float, logit_scale: float, seed: int,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(bins [m, n_features] int32, y [m] float32 in {0, 1})`` on
    ``device``, drawn from ``seed`` with one generator in a few large calls.
    A row's label is a Bernoulli draw at its teacher leaf's probability."""
    feat, thr, leaf_logit = _teacher(n_features, n_codes, depth, base_logit,
                                     logit_scale)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    bins = torch.randint(0, n_codes, (m, n_features), generator=gen,
                         device=device, dtype=torch.int32)
    feat_d = torch.as_tensor(feat, device=device)
    thr_d = torch.as_tensor(thr, device=device)
    node = torch.zeros(m, dtype=torch.long, device=device)
    for _ in range(depth):
        x = bins.gather(1, feat_d[node][:, None])[:, 0]
        node = 2 * node + 1 + (x > thr_d[node]).long()
    leaf = node - ((1 << depth) - 1)
    p = torch.sigmoid(torch.as_tensor(leaf_logit, dtype=torch.float32,
                                      device=device))[leaf]
    u = torch.rand(m, generator=gen, device=device)
    return bins, (u < p).to(torch.float32)
