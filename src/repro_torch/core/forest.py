"""Gradient-boosted UDT ensembles reusing Superfast Selection, in torch.

Counterpart of the boosting half of ``repro.core.forest``.
``GradientBoostedTrees`` is Newton-step boosting, generic in the loss via
``core.losses``: each round fits a ``regression_variance`` tree to the
Newton target ``z = -g/h`` with ``sample_weight = h``, so the histogram's
weight channel makes every leaf label ``-sum(g)/sum(h)`` (an exact Newton
step) and the ``sse`` split score ``(sum g)^2 / sum h`` (the XGBoost gain).
``loss="squared"`` (constant hessian) skips the weight channel when
unsampled.

GOSS (``GossConfig``): each round keeps the top-``a`` fraction of rows by
Newton leverage ``|g| sqrt(h)`` at weight 1 and a uniform ``b`` fraction of
the rest at weight ``(1-a)/b``; the weight multiplies the hessian weight.
The top set is RNG-free and taken with the reference's tie rule (lowest
index first among equal leverages); the remainder is drawn from one
``torch.Generator`` on the fit's device, seeded from ``seed`` and advanced
round by round, so the first r rounds of a fit are the r-round refit.  The
generator cannot draw the reference's threefry bits: parity tests feed the
reference's draws in by replacing ``_goss_sample``.

The fit runs on the card unless ``device="cpu"`` is passed: raw scores,
gradients, the ranking, the draw and the score update stay tensors on the
fit's device.  Every boosted round's histograms carry float weights, which
the CUDA kernel accumulates in fixed point, so two fits on the card give
the same trees bit for bit.

Not ported yet: ``RandomForest``, softmax (multiclass) boosting, round
checkpoints (``round_callback`` / ``resume_from``) and the mesh-sharded
fit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.binning import BinnedTable
from repro_torch.core.losses import get_loss
from repro_torch.core.predict import WALK_FIELDS, _walk, predict_bins, stack_trees
from repro_torch.core.tree import Tree, TreeConfig, build_tree, tree_from_numpy

__all__ = ["GradientBoostedTrees", "GossConfig", "ensemble_from_numpy"]


def _validate_fit_inputs(table: BinnedTable, y, sample_weight=None) -> None:
    """Reject non-finite training inputs at fit entry, naming the column or
    row: float bins (a caller that bypassed ``fit_bins``) must be finite,
    float labels finite, sample weights finite and non-negative."""
    bins = table.bins
    if isinstance(bins, torch.Tensor):
        bins = bins.cpu().numpy()
    if np.issubdtype(np.dtype(bins.dtype), np.floating):
        b = np.asarray(bins)
        bad = ~np.isfinite(b)
        if bad.any():
            col = int(np.argmax(bad.any(axis=0)))
            meta = (table.metas[col] if table.metas is not None
                    and col < len(table.metas) else None)
            name = f" ({meta.name!r})" if meta is not None else ""
            raise ValueError(
                f"non-finite feature values in column {col}{name}: "
                f"{int(bad[:, col].sum())} of {b.shape[0]} rows (first at "
                f"row {int(np.argmax(bad[:, col]))}).  Binned features "
                "must be finite -- raw NaNs belong in the missing bin "
                "(core.binning.fit_bins), a non-finite *bin* is a "
                "corrupted pipeline.")
    y_arr = np.asarray(y)
    if np.issubdtype(y_arr.dtype, np.floating):
        bad = ~np.isfinite(y_arr)
        if bad.any():
            raise ValueError(
                f"non-finite labels: {int(bad.sum())} of {y_arr.shape[0]} "
                f"rows (first at row {int(np.argmax(bad))}) -- refusing to "
                "train NaN trees")
    if sample_weight is not None:
        sw = np.asarray(sample_weight, dtype=np.float32)
        bad = ~np.isfinite(sw) | (sw < 0)
        if bad.any():
            raise ValueError(
                f"sample_weight must be finite and non-negative: "
                f"{int(bad.sum())} of {sw.shape[0]} rows violate this "
                f"(first at row {int(np.argmax(bad))})")


@dataclasses.dataclass(frozen=True)
class GossConfig:
    """Gradient-based One-Side Sampling for GradientBoostedTrees: keep the
    ``top_rate`` (a) fraction of rows with the largest leverage at weight
    1, plus an ``other_rate`` (b) fraction drawn uniformly from the rest at
    the amplification weight ``(1 - a) / b``, so every weighted statistic
    stays an unbiased estimate of its full-data value."""
    top_rate: float = 0.2
    other_rate: float = 0.1

    def __post_init__(self):
        if not 0.0 <= self.top_rate < 1.0:
            raise ValueError(f"top_rate must be in [0, 1), got {self.top_rate}")
        # tiny slack so e.g. (0.9, 0.1) survives 1.0 - 0.9 != 0.1 in floats
        if not 0.0 < self.other_rate <= 1.0 - self.top_rate + 1e-9:
            raise ValueError("other_rate must be in (0, 1 - top_rate], got "
                             f"{self.other_rate}")

    @property
    def amplification(self) -> float:
        """The small-gradient sample weight ``(1 - a) / b``."""
        return (1.0 - self.top_rate) / self.other_rate

    def sample_sizes(self, m: int) -> tuple[int, int]:
        """(top_n, other_n) for M rows; ``other_n`` is 0 when the top set
        already covers every row."""
        top_n = min(m, int(math.ceil(self.top_rate * m)))
        other_n = min(m - top_n, max(1, int(math.ceil(self.other_rate * m))))
        return top_n, other_n


def _top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, largest first, equal values in
    ascending index order: ``jax.lax.top_k``'s order (``torch.topk``
    promises no order among ties)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _goss_sample(rank, gen, *, top_n, other_n, amp):
    """One round's GOSS draw on ``rank``'s device: row indices
    ``[top_n + other_n]`` and their weights.

    The top set is the ``top_n`` largest ``|rank|``; the remainder is the
    ``other_n`` largest of ``M`` uniforms drawn from ``gen`` with the top
    set masked to -1.  M uniforms are drawn every round, so round r's draw
    depends only on the seed and r."""
    scores = torch.rand(rank.shape, generator=gen, device=rank.device)
    top_idx = _top_indices(rank.abs(), top_n)
    scores[top_idx] = -1.0
    other_idx = _top_indices(scores, other_n)
    idx = torch.cat([top_idx, other_idx])
    w = torch.cat([torch.ones(top_n, dtype=torch.float32, device=rank.device),
                   torch.full((other_n,), amp, dtype=torch.float32,
                              device=rank.device)])
    return idx, w


def _ensemble_predict(stacked, bins, n_num, lr, base, *, num_steps):
    """Every tree's Algorithm-7 walk, then ``base + lr * sum`` over trees."""
    per_tree = torch.stack([
        _walk({f: stacked[f][t] for f in WALK_FIELDS}, bins, n_num, 1 << 30,
              0, 0.0, num_steps)
        for t in range(stacked["feat"].shape[0])])               # [T, M]
    return base + lr * per_tree.sum(dim=0)


@dataclasses.dataclass
class GradientBoostedTrees:
    """Newton-step gradient boosting with variance-split UDTs.

    ``loss`` is "squared" (regression), "logistic" (binary classification)
    or a loss instance (``core.losses``).  Every round fits a
    ``regression_variance`` tree to ``z = -g/h`` with ``sample_weight = h``
    (GOSS amplification multiplied in when ``goss`` is set);
    ``config.min_child_weight`` bounds the per-child hessian sum.

    The predict surface is the reference's triple (device and host
    variants): ``predict_raw`` raw scores, ``predict_proba`` the link
    (rejected for regression losses), ``predict`` class ids for
    classification losses and raw values for regression.  The device
    variants run on the fit's device unless ``device`` is given.
    """
    n_trees: int = 20
    learning_rate: float = 0.3
    config: TreeConfig = dataclasses.field(
        default_factory=lambda: TreeConfig(max_depth=6,
                                           task="regression_variance"))
    goss: GossConfig | None = None
    loss: str = "squared"
    seed: int = 0

    def _resolve_loss(self, y):
        """``get_loss`` on ``self.loss``; the bare name "softmax" infers
        ``n_classes`` from the labels."""
        if isinstance(self.loss, str) and self.loss == "softmax":
            return get_loss(self.loss, n_classes=int(np.asarray(y).max()) + 1)
        return get_loss(self.loss)

    def fit(self, table: BinnedTable, y, *, sample_weight=None,
            level_callback=None, device=None):
        """Fit the ensemble on ``device`` (``None`` means CUDA).
        ``sample_weight`` ([M] f32) scales each example's gradient and
        hessian: the Newton target is unchanged and every fitted statistic
        becomes its weighted estimate."""
        # drop the stacked-walk cache first: a refit that fails midway must
        # never leave predict serving the previous fit's trees
        self._stacked = None
        _validate_fit_inputs(table, y, sample_weight)
        lo = self._loss = self._resolve_loss(y)
        if getattr(lo, "is_multiclass", False):
            raise NotImplementedError(
                "softmax (multiclass) boosting is not ported yet: it comes "
                "with the next slice of the port, with RandomForest and the "
                "batched class-tree build")
        dev = self._device = resolve_device(device)
        bins = torch.as_tensor(table.bins, dtype=torch.int32,
                               device=dev).contiguous()
        m = bins.shape[0]
        y = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=dev)
        sw = (torch.as_tensor(np.asarray(sample_weight), dtype=torch.float32,
                              device=dev)
              if sample_weight is not None else None)
        base = lo.base_score(y)
        self.n_num = np.asarray(table.n_num)
        n_num_d = torch.as_tensor(self.n_num, dtype=torch.int32, device=dev)
        dev_table = dataclasses.replace(table, bins=bins)
        lr = torch.tensor(self.learning_rate, dtype=torch.float32, device=dev)
        raw = base.expand(m)                     # additive scores, pre-link
        if self.goss is not None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            top_n, other_n = self.goss.sample_sizes(m)
            amp = self.goss.amplification
        self.trees: list[Tree] = []
        num_steps = max(1, self.config.max_depth)
        for _ in range(self.n_trees):
            g, h = lo.grad_hess(y, raw)
            # a row weight scales g and h alike: the Newton target is
            # weight-invariant, the weight enters through h (and the rank)
            z = lo.newton_target(g, h)
            if sw is not None:
                g, h = g * sw, h * sw
            use_w = sw is not None or not lo.constant_hessian
            if self.goss is None:
                tree = build_tree(dev_table, z, self.config,
                                  sample_weight=h if use_w else None,
                                  level_callback=level_callback, device=dev)
            else:
                rank = g * torch.sqrt(h) if use_w else g
                idx, w = _goss_sample(rank, gen, top_n=top_n,
                                      other_n=other_n, amp=amp)
                if use_w:
                    w = w * h[idx]               # GOSS amp x hessian weight
                sub_table = dataclasses.replace(table, bins=bins[idx])
                tree = build_tree(sub_table, z[idx], self.config,
                                  sample_weight=w,
                                  level_callback=level_callback, device=dev)
            self.trees.append(tree)
            # two f32 ops, the expression the ensemble sweep replays
            raw = raw + lr * predict_bins(tree, bins, n_num_d,
                                          num_steps=num_steps, device=dev)
        self.base = float(base)                  # one scalar sync at the end
        return self

    def _fitted_loss(self):
        """The loss instance the fit ran with (falls back to resolving
        ``self.loss`` for an unfitted estimator)."""
        lo = getattr(self, "_loss", None)
        return lo if lo is not None else get_loss(self.loss)

    def predict_raw_device(self, bins, device=None) -> torch.Tensor:
        """Raw (pre-link) ensemble scores [M] as a tensor on the fit's
        device (or ``device``); the stacked tree arrays are built once."""
        dev = (self._device if device is None else resolve_device(device))
        cached = getattr(self, "_stacked", None)
        if cached is None or cached[1].device != dev:
            stacked = {f: v.to(dev) for f, v in stack_trees(self.trees).items()}
            self._stacked = cached = (
                stacked, torch.as_tensor(self.n_num, dtype=torch.int32,
                                         device=dev))
        stacked, n_num_d = cached
        f32 = dict(dtype=torch.float32, device=dev)
        return _ensemble_predict(
            stacked, torch.as_tensor(bins, dtype=torch.int32, device=dev),
            n_num_d, torch.tensor(self.learning_rate, **f32),
            torch.tensor(self.base, **f32),
            num_steps=max(1, self.config.max_depth))

    def predict_proba_device(self, bins, device=None) -> torch.Tensor:
        """Sigmoid P(y=1) [M] for the logistic loss; rejected for regression
        losses (identity link)."""
        lo = self._fitted_loss()
        if lo.link_id == 0:
            raise ValueError(
                f"loss {lo.name!r} is a regression objective (identity "
                "link); it has no class probabilities -- use predict / "
                "predict_raw")
        return lo.link(self.predict_raw_device(bins, device))

    def predict_device(self, bins, device=None) -> torch.Tensor:
        """Class ids [M] int32 for the logistic loss (raw > 0), raw values
        [M] for regression."""
        raw = self.predict_raw_device(bins, device)
        if self._fitted_loss().link_id == 1:
            return (raw > 0).to(torch.int32)
        return raw

    def predict_raw(self, bins):
        return self.predict_raw_device(bins).cpu().numpy()

    def predict_proba(self, bins):
        return self.predict_proba_device(bins).cpu().numpy()

    def predict(self, bins):
        """Ensemble prediction as numpy: one device -> host transfer."""
        return self.predict_device(bins).cpu().numpy()

    def sweep(self, val_bins, y_val, **kwargs):
        """Price the ensemble's ``(n_rounds x max_depth x min_samples_split
        x min_child_weight)`` design space from this one fit
        (``core.tuning.sweep``; keyword arguments pass through)."""
        from repro_torch.core import tuning
        kwargs.setdefault("device", self._device)
        return tuning.sweep(self, val_bins, y_val, **kwargs)

    def export_stacked(self):
        """``(tables, n_num, meta)`` for serving: the stacked ``[T,
        max_nodes]`` WALK_FIELDS arrays ``predict_device`` walks, the
        ``[K]`` numeric-bin counts, and the serving scalars
        (``learning_rate``, ``base``, ``link_id``, ``n_classes``,
        ``num_steps``, ``loss``)."""
        lo = self._fitted_loss()
        return (stack_trees(self.trees), np.asarray(self.n_num),
                dict(learning_rate=float(self.learning_rate),
                     base=float(self.base), link_id=int(lo.link_id),
                     n_classes=1, num_steps=max(1, self.config.max_depth),
                     loss=lo.name))


def ensemble_from_numpy(trees, *, base, learning_rate, loss, n_num,
                        config: TreeConfig | None = None,
                        device=None) -> GradientBoostedTrees:
    """A fitted ``GradientBoostedTrees`` from numpy state, e.g. a reference
    ``repro.core.GradientBoostedTrees``: ``trees`` is a sequence of field
    dicts that each carry ``n_nodes`` (a reference ``Tree._asdict()``),
    ``loss`` a registered name.  Its trees stay on the CPU; prediction runs
    on ``device`` (``None`` means CUDA)."""
    ens = GradientBoostedTrees(
        n_trees=len(trees), learning_rate=float(learning_rate),
        config=config if config is not None else GradientBoostedTrees().config,
        loss=loss)
    ens.trees = [tree_from_numpy(t, t["n_nodes"]) for t in trees]
    ens.base = float(base)
    ens.n_num = np.asarray(n_num)
    ens._loss = get_loss(loss)
    ens._device = resolve_device(device)
    ens._stacked = None
    return ens
