"""Kernel D, the score walk of paper Algorithm 7: the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces no Pallas kernel: the reference walks with plain XLA
(``repro.core.predict._walk`` / ``walk_class_trees``).  T trees' stacked
``WALK_FIELDS`` (``[T, N]`` each, in ``FIELD_DTYPES``) walk the rows of
``bins [M, K]`` from the root for ``steps`` steps -> leaf labels ``[T, M]``
f32.  A row descends where its node is no leaf, has a left child, counts
at least ``min_samples_split`` examples and, for a ``min_child_weight``
above 0, its lighter child counts more than that (compared in float32);
it goes left where ``evaluate_predicate`` holds on its code.  ``n_num`` is
``[K]``, or ``[T, K]`` for trees with their own feature masks.  The depth
limit is the step count: the caller passes ``min(num_steps, max_depth -
1)``.

``walk_cuda`` launches ``csrc/walk.cu`` (one launch for all T trees; the
source says what bounds it).  ``walk_plain`` is the Python loop of gathers
over ``[T, M]``: the CPU path and the kernel's yardstick on the card.
Both give the same labels bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.split import evaluate_predicate
from repro_torch.kernels import _build, _checks
from repro_torch.kernels._checks import is_fake, need, stream_of

__all__ = ["FIELD_DTYPES", "walk_cuda", "walk_plain"]

# the Tree fields the walk reads, in their dtypes
FIELD_DTYPES = dict(feat=torch.int32, op=torch.int32, tbin=torch.int32,
                    label=torch.float32, count=torch.int32, left=torch.int32,
                    right=torch.int32, leaf=torch.bool)


def walk_plain(fields, bins, n_num, *, steps, min_samples_split=0,
               min_child_weight=0.0):
    """The walk as a loop of ``[T, M]`` gathers, ``steps`` times."""
    node = torch.zeros((fields["feat"].shape[0], bins.shape[0]),
                       dtype=torch.long, device=bins.device)
    bins_t = bins.t()

    def at(name, idx=None):
        return fields[name].gather(1, node if idx is None else idx)

    for _ in range(steps):
        left = at("left")
        can = ~at("leaf") & (left >= 0) & (at("count") >= min_samples_split)
        if not min_child_weight <= 0:
            # build_tree's stopping rule; the index guards keep the gathers
            # in bounds at leaves (where can is already False)
            child_min = torch.minimum(
                at("count", left.clamp(min=0).long()),
                at("count", at("right").clamp(min=0).long()))
            can = can & (child_min > min_child_weight)
        f = at("feat").clamp(min=0).long()
        nn = n_num.gather(1, f) if n_num.dim() == 2 else n_num[f]
        pos = evaluate_predicate(bins_t.gather(0, f), nn, at("op"),
                                 at("tbin"))
        node = torch.where(can, torch.where(pos, left, at("right")).long(),
                           node)
    return at("label")


def walk_cuda(fields, bins, n_num, *, steps, n_nodes=None,
              min_samples_split=0, min_child_weight=0.0):
    """Launch the CUDA walk.  ``n_nodes`` (a host int, default every slot)
    is the count of leading slots that hold every node reachable from the
    root: the kernel stages those alone, and a child outside them ends a
    row's walk.  ``walk_cuda.launches`` counts its launches (on fake
    tensors: none, see ``_checks``)."""
    dev = bins.device
    fake = is_fake(bins)
    stream = 0 if fake else stream_of(dev)
    if bins.dim() != 2:
        raise ValueError(f"bins: expected [M, K], got {tuple(bins.shape)}")
    m, k = bins.shape
    p_bins = need(bins, "bins", torch.int32, (m, k), dev)
    if fields["feat"].dim() != 2:
        raise ValueError(f"feat: expected [T, N], got "
                         f"{tuple(fields['feat'].shape)}")
    t, width = fields["feat"].shape
    ld = fields["feat"].stride(0)
    ptrs = [need(fields[f], f, dtype, (t, width), dev, row_stride=ld)
            for f, dtype in FIELD_DTYPES.items()]
    n = width if n_nodes is None else int(n_nodes)
    if t and not 1 <= n <= width:
        raise ValueError(f"n_nodes {n}: the trees have {width} slots")
    per_tree = n_num.dim() == 2
    p_num = need(n_num, "n_num", torch.int32, (t, k) if per_tree else (k,),
                 dev)
    out = torch.empty((t, m), dtype=torch.float32, device=dev)
    if t * m and fake:
        _checks.report("walk", ())
    elif t * m:
        lib = _build.library()
        mcw = float(min_child_weight)
        _build.check(lib.udt_walk(
            *ptrs, ld, p_bins, p_num, k if per_tree else 0, out.data_ptr(),
            t, n, m, k, min(int(steps), (1 << 31) - 1),
            int(min_samples_split), int(not mcw <= 0), mcw, stream), "walk")
        walk_cuda.launches += 1
        _checks.report("walk", (), lambda: lib.udt_walk_smem(t, n, k))
    return out


walk_cuda.launches = 0
