"""Plain reference of Newton boosting with GOSS on the logistic loss
(PyTorch, no kernels).

A round: ``p = sigmoid(raw)``, ``g = p - y``, ``h = max(p (1 - p), 1e-6)``;
GOSS keeps the ``top_n`` rows of largest leverage ``|g| sqrt(h)`` (equal
leverages by lowest row first) at weight 1 and, of the rest, the
``other_n`` rows with the largest of ``M`` uniforms drawn that round at
weight ``(1 - a) / b``; each kept row's weight is multiplied by its
hessian.  The round's tree fits the Newton target ``z = -g / h`` under
those weights (so a leaf's value is ``-sum(w g) / sum(w h)`` up to the
amplification), and ``raw += lr * tree(x)``.  The base score is the
log-odds of the positive share.

The uniforms of round ``r`` are the ``r``-th ``M``-long draw of one
``torch.Generator`` on the rows' device seeded with the fit's seed: the
seed of the GOSS draws is an input that the benchmark hands both sides.

``replay`` follows a fit whose trees it is given: it recomputes every
round's scores, gradients and sample from those trees, in float32 with the
same operation order as a float32 fit, so the sample it draws is the one a
sound fit drew.  ``fit`` grows the trees itself (``tree.grow``) in a dtype
of the caller's choice: the control.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference.tree import Rules, grow, walk

__all__ = ["Goss", "base_score", "grad_hess", "goss_sample", "replay", "fit",
           "moment_stats"]


@dataclasses.dataclass(frozen=True)
class Goss:
    top_rate: float
    other_rate: float

    def sizes(self, m: int):
        top_n = min(m, int(math.ceil(self.top_rate * m)))
        other_n = min(m - top_n, max(1, int(math.ceil(self.other_rate * m))))
        return top_n, other_n

    @property
    def amp(self) -> float:
        return (1.0 - self.top_rate) / self.other_rate


def base_score(y):
    p = torch.clamp(torch.mean(y), 1e-6, 1.0 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def grad_hess(raw, y):
    p = torch.sigmoid(raw)
    return p - y, torch.clamp(p * (1.0 - p), min=1e-6)


def goss_sample(g, h, u, goss: Goss):
    """``(rows, weight)``: the kept rows, top set first, and each one's
    GOSS weight times its hessian."""
    m = g.shape[0]
    top_n, other_n = goss.sizes(m)
    top = torch.sort((g * torch.sqrt(h)).abs(), descending=True,
                     stable=True).indices[:top_n]
    u = u.clone()
    u[top] = -1.0
    other = torch.sort(u, descending=True, stable=True).indices[:other_n]
    rows = torch.cat([top, other])
    w = torch.cat([torch.ones(top_n, device=g.device),
                   torch.full((other_n,), goss.amp, device=g.device)])
    return rows, w * h[rows]


def moment_stats(z, w, dtype):
    """Rows' ``(w, w z, w z^2)`` in ``dtype``."""
    z = z.to(dtype)
    w = w.to(dtype)
    return torch.stack([w, w * z, w * z * z], 1)


def _tensors(tree: dict, dev):
    return {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in tree.items()}


def replay(trees, bins, y, n_num, *, lr: float, goss: Goss, seed: int,
           steps: int, visit=None):
    """Walk a fit's rounds from its trees.  ``visit(r, rows, w, z)`` is
    called with round ``r``'s sample (rows, weights, Newton targets) before
    the round's tree is added to the scores."""
    dev = bins.device
    m = bins.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    raw = base_score(y).expand(m)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    for r, tree in enumerate(trees):
        g, h = grad_hess(raw, y)
        u = torch.rand((m,), generator=gen, device=dev)
        rows, w = goss_sample(g, h, u, goss)
        if visit is not None:
            visit(r, rows, w, (-g / h)[rows])
        raw = raw + lr_t * walk(_tensors(tree, dev), bins, n_num, steps)
    return raw


def fit(bins, y, n_num, n_cat, n_bins: int, *, rounds: int, lr: float,
        goss: Goss, seed: int, rules: Rules, dtype) -> list:
    """Grow ``rounds`` trees with sums and scores in ``dtype``; the rounds'
    scores stay in float32."""
    dev = bins.device
    m = bins.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    raw = base_score(y).expand(m)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    trees = []
    for _ in range(rounds):
        g, h = grad_hess(raw, y)
        u = torch.rand((m,), generator=gen, device=dev)
        rows, w = goss_sample(g, h, u, goss)
        tree = grow(bins[rows], moment_stats((-g / h)[rows], w, dtype),
                    n_num, n_cat, n_bins, rules, dtype)
        trees.append(tree)
        raw = raw + lr_t * walk(_tensors(tree, dev), bins, n_num,
                                rules.max_depth).to(torch.float32)
    return trees
