"""Tree ensembles reusing Superfast Selection, in torch.

Counterpart of ``repro.core.forest``.

``RandomForest``: bootstrap rows and a feature mask per tree, both drawn
with numpy's ``default_rng(seed)`` exactly as the reference draws them, so
both packages see the same rows.  A masked feature gets ``n_num = n_cat =
0`` and is never selectable, so every tree shares the one binned table; it
stays on the fit's device and each tree's bootstrap is gathered there.
Prediction walks every tree at once (``walk_class_trees`` with per-tree
feature masks) and counts votes.

``GradientBoostedTrees`` is Newton-step boosting, generic in the loss via
``core.losses``: each round fits a ``regression_variance`` tree to the
Newton target ``z = -g/h`` with ``sample_weight = h``, so the histogram's
weight channel makes every leaf label ``-sum(g)/sum(h)`` (an exact Newton
step) and the ``sse`` split score ``(sum g)^2 / sum h`` (the XGBoost gain).
``loss="squared"`` (constant hessian) skips the weight channel when
unsampled.  ``loss="softmax"`` is multiclass: raw scores are class-first
``[C, M]``, and a round's C class-trees grow through ONE batched build
(``core.tree.build_trees_batched``: one class-stacked histogram launch and
one split-scan launch per level chunk), appended round-major.

GOSS (``GossConfig``): each round keeps the top-``a`` fraction of rows by
Newton leverage ``|g| sqrt(h)`` (softmax: ``sqrt(sum_c g_c^2 h_c)``, one
draw shared by the classes) at weight 1 and a uniform ``b`` fraction of
the rest at weight ``(1-a)/b``; the weight multiplies the hessian weight.
The top set is RNG-free and taken with the reference's tie rule (lowest
index first among equal leverages); the remainder is drawn from one
``torch.Generator`` on the fit's device, seeded from ``seed`` and advanced
round by round, so the first r rounds of a fit are the r-round refit.  The
generator cannot draw the reference's threefry bits: parity tests feed the
reference's draws in by replacing ``_goss_sample``.

Round checkpoints (``checkpoint.round_ckpt``): ``fit(round_callback=...)``
hands a ``RoundState`` (trees, raw scores, generator state, digest) to the
callback after every round, and ``fit(resume_from=...)`` re-enters the
loop there, giving the uninterrupted fit bit for bit.

The fits run on the card unless ``device="cpu"`` is passed.  Every boosted
round's histograms carry float weights, which the CUDA kernel accumulates
in fixed point, so two fits on the card give the same trees bit for bit.

Not ported yet: the sharded boosting loop (``mesh=`` / ``dist=``: the
sharded GOSS sampler and score walk around ``core.distributed``'s build).
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.binning import BinnedTable
from repro_torch.core.losses import get_loss
from repro_torch.core.predict import (predict_bins, stack_trees,
                                      walk_class_trees)
from repro_torch.core.tree import (TREE_FIELDS, Tree, TreeConfig, build_tree,
                                   build_trees_batched, tree_from_numpy)

__all__ = ["RandomForest", "GradientBoostedTrees", "GossConfig",
           "ensemble_from_numpy", "sum_tree_lanes"]


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


def _subsample_table(table: BinnedTable, feat_mask: np.ndarray) -> BinnedTable:
    """Mask out features by zeroing their bin ranges (never selectable)."""
    return dataclasses.replace(
        table, n_num=np.where(feat_mask, table.n_num, 0).astype(np.int32),
        n_cat=np.where(feat_mask, table.n_cat, 0).astype(np.int32))


def _forest_votes(stacked, n_nums, bins, *, num_steps, n_classes):
    """Every tree's Algorithm-7 walk at once (each with its own feature
    mask ``n_nums[t]``), then the ``[M, C]`` vote counts.  Integer counts
    are exact in f32, so argmax reproduces a per-tree vote loop."""
    per_tree = walk_class_trees(stacked, bins, n_nums,
                                num_steps=num_steps)               # [T, M]
    return torch.nn.functional.one_hot(per_tree.long(), n_classes).to(
        torch.float32).sum(dim=0)                                  # [M, C]


@dataclasses.dataclass
class RandomForest:
    """Bagged classification UDTs: each tree sees a bootstrap of the rows
    and a random ``max_features`` fraction of the features."""
    n_trees: int = 10
    max_features: float = 0.7         # fraction of features per tree
    bootstrap: bool = True
    config: TreeConfig = dataclasses.field(
        default_factory=lambda: TreeConfig(max_depth=24))
    seed: int = 0

    def fit(self, table: BinnedTable, y, n_classes: int | None = None, *,
            sample_weight=None, level_callback=None, device=None):
        """Fit the forest on int class labels ``y`` on ``device`` (``None``
        means CUDA).  ``sample_weight`` ([M] f32) enters each tree's weight
        channel under the bootstrap; ``level_callback`` is every tree's
        per-level hook.  ``n_classes`` is inferred from the labels; passing
        it still works, with a DeprecationWarning, as in the reference."""
        if n_classes is not None:
            warnings.warn(
                "passing n_classes to RandomForest.fit is deprecated and "
                "will be removed in the next release; it is now inferred "
                "from the labels", DeprecationWarning, stacklevel=2)
        # drop the stacked-walk cache first: a refit that fails midway must
        # never leave predict serving the previous fit's trees
        self._stacked = None
        _validate_fit_inputs(table, y, sample_weight)
        dev = self._device = resolve_device(device)
        rng = np.random.default_rng(self.seed)
        m, k = table.bins.shape
        y = np.asarray(y)
        self.n_classes = (int(n_classes) if n_classes is not None
                          else int(y.max()) + 1)
        sw = (np.asarray(sample_weight, dtype=np.float32)
              if sample_weight is not None else None)
        # the table goes to the device once; bootstraps are gathered there
        bins = torch.as_tensor(table.bins, dtype=torch.int32,
                               device=dev).contiguous()
        self.trees: list[Tree] = []
        # predict needs each tree's feature mask (n_num), not its rows
        self.n_nums: list[np.ndarray] = []
        for _ in range(self.n_trees):
            fm = rng.uniform(size=k) < self.max_features
            if not fm.any():
                fm[rng.integers(0, k)] = True
            sub = dataclasses.replace(_subsample_table(table, fm), bins=bins)
            if self.bootstrap:
                idx = rng.integers(0, m, size=m)
                sub = dataclasses.replace(
                    sub, bins=bins[torch.from_numpy(idx).to(dev)])
                yy, ww = y[idx], (sw[idx] if sw is not None else None)
            else:
                yy, ww = y, sw
            self.trees.append(build_tree(
                sub, yy, self.config, n_classes=self.n_classes,
                sample_weight=ww, level_callback=level_callback, device=dev))
            self.n_nums.append(sub.n_num)
        return self

    def _votes(self, bins, device=None) -> torch.Tensor:
        dev = self._device if device is None else resolve_device(device)
        cached = getattr(self, "_stacked", None)
        if cached is None or cached[1].device != dev:
            self._stacked = cached = (
                {f: v.to(dev) for f, v in stack_trees(self.trees).items()},
                torch.as_tensor(np.stack(self.n_nums), dtype=torch.int32,
                                device=dev),
                max(1, max(t.max_tree_depth for t in self.trees)))
        stacked, n_nums, steps = cached
        return _forest_votes(stacked, n_nums,
                             torch.as_tensor(bins, dtype=torch.int32,
                                             device=dev),
                             num_steps=steps, n_classes=self.n_classes)

    # -- the predict triple (device and host variants) --------------------
    def predict_raw_device(self, bins, device=None) -> torch.Tensor:
        """Per-class vote counts [M, C] on the fit's device (or
        ``device``); the stacked tree arrays are built once."""
        return self._votes(bins, device)

    def predict_proba_device(self, bins, device=None) -> torch.Tensor:
        """Vote fractions [M, C] (counts / n_trees)."""
        return self._votes(bins, device) / float(self.n_trees)

    def predict_device(self, bins, device=None) -> torch.Tensor:
        """Majority-vote class ids [M] int32 (ties go to the lowest id)."""
        return torch.argmax(self._votes(bins, device), dim=1).to(torch.int32)

    def predict_raw(self, bins):
        return self.predict_raw_device(bins).cpu().numpy()

    def predict_proba(self, bins):
        return self.predict_proba_device(bins).cpu().numpy()

    def predict(self, bins):
        """Class ids [M] as numpy: one device -> host transfer."""
        return self.predict_device(bins).cpu().numpy()


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


def sum_tree_lanes(per_tree: torch.Tensor) -> torch.Tensor:
    """Sum ``[T, M]`` per-tree values over trees, left to right: one fixed
    order whatever ``T`` is, so trailing lanes of exact zeros (the serve
    registry's padded trees) leave the sum's bits unchanged.  A reduction
    over the tree axis need not add the lanes in the same order for
    another ``T``."""
    acc = per_tree[0]
    for lane in per_tree[1:]:
        acc = acc + lane
    return acc


def _ensemble_predict(stacked, bins, n_num, lr, base, *, num_steps):
    """Every tree's Algorithm-7 walk, then ``base + lr * sum`` over trees
    (``sum_tree_lanes``: the order the routed serve walk adds them in)."""
    per_tree = walk_class_trees(stacked, bins, n_num,
                                num_steps=num_steps)               # [T, M]
    return base + lr * sum_tree_lanes(per_tree)


def _ensemble_predict_multiclass(stacked, bins, n_num, lr, base, *,
                                 num_steps, n_classes):
    """The softmax twin: the stacked ``[R*C, max_nodes]`` arrays hold R
    rounds of C class-trees round-major (the order ``fit`` appends them),
    so one walk and a ``[R, C, M]`` reduce give the per-class scores.
    Returns class-last ``[M, C]``, the prediction layout."""
    per_tree = walk_class_trees(stacked, bins, n_num,
                                num_steps=num_steps)               # [R*C, M]
    per_class = per_tree.reshape(-1, n_classes,
                                 per_tree.shape[1]).sum(dim=0)     # [C, M]
    return (base[:, None] + lr * per_class).T


@dataclasses.dataclass
class GradientBoostedTrees:
    """Newton-step gradient boosting with variance-split UDTs.

    ``loss`` is "squared" (regression), "logistic" (binary
    classification), "softmax" (multiclass; ``n_classes`` inferred from the
    labels, or pinned with a ``SoftmaxLoss`` instance) or a loss instance
    (``core.losses``).  Every round fits a ``regression_variance`` tree to
    ``z = -g/h`` with ``sample_weight = h`` (GOSS amplification multiplied
    in when ``goss`` is set), one per class for softmax;
    ``config.min_child_weight`` bounds the per-child hessian sum.

    The predict surface is the reference's triple (device and host
    variants): ``predict_raw`` raw scores ([M], class-last [M, C] for
    softmax), ``predict_proba`` the link (rejected for regression losses),
    ``predict`` class ids for classification losses and raw values for
    regression.  The device variants run on the fit's device unless
    ``device`` is given.
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
            level_callback=None, round_callback=None, resume_from=None,
            device=None):
        """Fit the ensemble on ``device`` (``None`` means CUDA).
        ``sample_weight`` ([M] f32) scales each example's gradient and
        hessian: the Newton target is unchanged and every fitted statistic
        becomes its weighted estimate.

        ``round_callback`` receives a ``RoundState`` after every round
        (``checkpoint.RoundCheckpointer`` saves it); ``resume_from`` (a
        checkpoint directory or a restored ``RoundCheckpoint``) re-enters
        the loop at the checkpointed round with its trees, raw scores and
        generator state, and gives the uninterrupted fit bit for bit.  A
        checkpoint of another fit raises ``CheckpointMismatchError``."""
        # drop the stacked-walk cache first: a refit that fails midway must
        # never leave predict serving the previous fit's trees
        self._stacked = None
        _validate_fit_inputs(table, y, sample_weight)
        lo = self._loss = self._resolve_loss(y)
        dev = self._device = resolve_device(device)
        digest = None
        if round_callback is not None or resume_from is not None:
            from repro_torch.checkpoint.round_ckpt import fit_digest
            digest = fit_digest(self, table, y, sample_weight, device=dev)
        bins = torch.as_tensor(table.bins, dtype=torch.int32,
                               device=dev).contiguous()
        m = bins.shape[0]
        sw = (torch.as_tensor(np.asarray(sample_weight), dtype=torch.float32,
                              device=dev)
              if sample_weight is not None else None)
        self.n_num = np.asarray(table.n_num)
        n_num_d = torch.as_tensor(self.n_num, dtype=torch.int32, device=dev)
        dev_table = dataclasses.replace(table, bins=bins)
        lr = torch.tensor(self.learning_rate, dtype=torch.float32, device=dev)
        # the GOSS remainder's draws; its state is the round checkpoint's key
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        if self.goss is not None:
            top_n, other_n = self.goss.sample_sizes(m)
            amp = self.goss.amplification
        multiclass = getattr(lo, "is_multiclass", False)
        y = torch.as_tensor(np.asarray(y), device=dev,
                            dtype=torch.int64 if multiclass else torch.float32)
        base = lo.base_score(y)                  # [C] log-priors for softmax
        raw = (base[:, None].expand(lo.n_classes, m) if multiclass
               else base.expand(m))              # additive scores, pre-link
        self.trees: list[Tree] = []
        num_steps = max(1, self.config.max_depth)
        start, raw = self._apply_resume(resume_from, digest, raw, gen, dev)
        for r in range(start, self.n_trees):
            g, h = lo.grad_hess(y, raw)          # [C, M] each for softmax
            # a row weight scales g and h alike: the Newton target is
            # weight-invariant, the weight enters through h (and the rank)
            z = lo.newton_target(g, h)
            if sw is not None:
                g, h = g * sw, h * sw
            use_w = sw is not None or not lo.constant_hessian
            if multiclass:
                raw = raw + lr * self._round_multiclass(
                    dev_table, table, bins, z, g, h, gen, n_num_d, num_steps,
                    level_callback, dev)
            else:
                if self.goss is None:
                    tree = build_tree(dev_table, z, self.config,
                                      sample_weight=h if use_w else None,
                                      level_callback=level_callback,
                                      device=dev)
                else:
                    rank = g * torch.sqrt(h) if use_w else g
                    idx, w = _goss_sample(rank, gen, top_n=top_n,
                                          other_n=other_n, amp=amp)
                    if use_w:
                        w = w * h[idx]           # GOSS amp x hessian weight
                    sub_table = dataclasses.replace(table, bins=bins[idx])
                    tree = build_tree(sub_table, z[idx], self.config,
                                      sample_weight=w,
                                      level_callback=level_callback,
                                      device=dev)
                self.trees.append(tree)
                # two f32 ops, the expression the ensemble sweep replays
                raw = raw + lr * predict_bins(tree, bins, n_num_d,
                                              num_steps=num_steps, device=dev)
            if round_callback is not None:
                round_callback(self._round_state(r + 1, raw, gen, digest))
        # one sync at the end: a scalar, or the [C] log-priors
        self.base = (base.cpu().numpy().astype(np.float32) if multiclass
                     else float(base))
        return self

    def _round_multiclass(self, dev_table, table, bins, z, g, h, gen,
                          n_num_d, num_steps, level_callback, dev):
        """One softmax round: the C class-trees through ONE batched build
        (under GOSS on one shared row draw ranked by ``sqrt(sum_c g_c^2
        h_c)``, each class's hessians on the shared weights), appended to
        ``self.trees``; returns their ``[C, M]`` leaf labels."""
        if self.goss is None:
            round_trees, arrays = build_trees_batched(
                dev_table, z, self.config, sample_weight=h,
                level_callback=level_callback, device=dev)
        else:
            top_n, other_n = self.goss.sample_sizes(bins.shape[0])
            rank = torch.sqrt(torch.sum(g * g * h, dim=0))
            idx, w = _goss_sample(rank, gen, top_n=top_n, other_n=other_n,
                                  amp=self.goss.amplification)
            round_trees, arrays = build_trees_batched(
                dataclasses.replace(table, bins=bins[idx]), z[:, idx],
                self.config, sample_weight=w[None] * h[:, idx],
                level_callback=level_callback, device=dev)
        self.trees.extend(round_trees)
        return walk_class_trees(arrays, bins, n_num_d, num_steps=num_steps)

    def _round_state(self, completed: int, raw, gen, digest):
        from repro_torch.checkpoint.round_ckpt import RoundState
        return RoundState(round=completed, trees=self.trees, raw=raw,
                          key=gen.get_state(), digest=digest)

    def _apply_resume(self, resume_from, digest, raw, gen, dev):
        """Swap in a round checkpoint's (trees, raw, generator state) after
        the digest check; returns ``(start_round, raw)``."""
        if resume_from is None:
            return 0, raw
        from repro_torch.checkpoint.round_ckpt import resolve_resume
        ck = resolve_resume(resume_from, digest)
        self.trees = [t._replace(**{f: getattr(t, f).to(dev)
                                    for f in TREE_FIELDS})
                      for t in ck.trees]
        gen.set_state(torch.as_tensor(np.asarray(ck.key), dtype=torch.uint8))
        return ck.round, torch.as_tensor(np.asarray(ck.raw),
                                         dtype=torch.float32, device=dev)

    def _fitted_loss(self):
        """The loss instance the fit ran with (falls back to resolving
        ``self.loss`` for an unfitted estimator)."""
        lo = getattr(self, "_loss", None)
        return lo if lo is not None else get_loss(self.loss)

    def predict_raw_device(self, bins, device=None) -> torch.Tensor:
        """Raw (pre-link) ensemble scores on the fit's device (or
        ``device``): [M] for scalar losses, class-last [M, C] for softmax.
        The stacked tree arrays are built once."""
        dev = (self._device if device is None else resolve_device(device))
        cached = getattr(self, "_stacked", None)
        if cached is None or cached[1].device != dev:
            stacked = {f: v.to(dev) for f, v in stack_trees(self.trees).items()}
            self._stacked = cached = (
                stacked, torch.as_tensor(self.n_num, dtype=torch.int32,
                                         device=dev))
        stacked, n_num_d = cached
        f32 = dict(dtype=torch.float32, device=dev)
        bins = torch.as_tensor(bins, dtype=torch.int32, device=dev)
        lr = torch.tensor(self.learning_rate, **f32)
        num_steps = max(1, self.config.max_depth)
        lo = self._fitted_loss()
        if getattr(lo, "is_multiclass", False):
            return _ensemble_predict_multiclass(
                stacked, bins, n_num_d, lr, torch.as_tensor(self.base, **f32),
                num_steps=num_steps, n_classes=lo.n_classes)      # [M, C]
        return _ensemble_predict(stacked, bins, n_num_d, lr,
                                 torch.tensor(self.base, **f32),
                                 num_steps=num_steps)              # [M]

    def predict_proba_device(self, bins, device=None) -> torch.Tensor:
        """Link-applied probabilities: [M] sigmoid P(y=1) for the logistic
        loss, [M, C] softmax for multiclass; rejected for regression
        losses (identity link)."""
        lo = self._fitted_loss()
        if lo.link_id == 0:
            raise ValueError(
                f"loss {lo.name!r} is a regression objective (identity "
                "link); it has no class probabilities -- use predict / "
                "predict_raw")
        return lo.link(self.predict_raw_device(bins, device))

    def predict_device(self, bins, device=None) -> torch.Tensor:
        """Class ids [M] int32 for classification losses (argmax over the
        softmax classes, first maximum; raw > 0 for logistic), raw values
        [M] for regression."""
        raw = self.predict_raw_device(bins, device)
        lo = self._fitted_loss()
        if getattr(lo, "is_multiclass", False):
            return torch.argmax(raw, dim=1).to(torch.int32)
        if lo.link_id == 1:
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
        (``learning_rate``, ``base`` -- a float, or the [C] log-prior list
        for softmax --, ``link_id``, ``n_classes``, ``num_steps``,
        ``loss``)."""
        lo = self._fitted_loss()
        multiclass = getattr(lo, "is_multiclass", False)
        base = ([float(b) for b in np.asarray(self.base)] if multiclass
                else float(self.base))
        return (stack_trees(self.trees), np.asarray(self.n_num),
                dict(learning_rate=float(self.learning_rate), base=base,
                     link_id=int(lo.link_id),
                     n_classes=int(lo.n_classes) if multiclass else 1,
                     num_steps=max(1, self.config.max_depth), loss=lo.name))


def ensemble_from_numpy(trees, *, base, learning_rate, loss, n_num,
                        config: TreeConfig | None = None,
                        device=None) -> GradientBoostedTrees:
    """A fitted ``GradientBoostedTrees`` from numpy state, e.g. a reference
    ``repro.core.GradientBoostedTrees``: ``trees`` is a sequence of field
    dicts that each carry ``n_nodes`` (a reference ``Tree._asdict()``),
    ``loss`` a registered name, ``base`` a float or, for "softmax", the
    [C] log-priors (C classes, trees round-major).  Its trees stay on the
    CPU; prediction runs on ``device`` (``None`` means CUDA)."""
    multiclass = np.ndim(base) == 1
    ens = GradientBoostedTrees(
        n_trees=len(trees), learning_rate=float(learning_rate),
        config=config if config is not None else GradientBoostedTrees().config,
        loss=loss)
    ens.trees = [tree_from_numpy(t, t["n_nodes"]) for t in trees]
    ens.base = (np.array(base, dtype=np.float32) if multiclass
                else float(base))
    ens.n_num = np.asarray(n_num)
    ens._loss = (get_loss(loss, n_classes=len(ens.base)) if multiclass
                 else get_loss(loss))
    ens._device = resolve_device(device)
    ens._stacked = None
    return ens
