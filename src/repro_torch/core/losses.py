"""Boosting losses: first/second-order pieces for Newton-step GBT, in torch.

Counterpart of ``repro.core.losses``.  The boosted-ensemble loop
(``core.forest.GradientBoostedTrees``) is generic in the loss through four
pieces, all tensor functions on the device of their inputs:

  * ``base_score(y)`` -- the constant raw score F0 minimising the loss
    (mean for squared error, the base-rate log-odds for logistic),
  * ``grad_hess(y, raw)`` -- per-example gradient g_i and hessian h_i at
    the current raw scores,
  * ``newton_target(g, h)`` -- the working response ``z = -g/h`` each
    round's ``regression_variance`` tree is fit to, with
    ``sample_weight = h``: the weight channel then accumulates
    ``(sum h, sum h z, sum h z^2)``, so every leaf is the Newton step
    ``-sum(g)/sum(h)`` and the ``sse`` split score is ``(sum g)^2/sum h``,
  * ``link(raw)`` -- raw ensemble score -> user-facing prediction.

``constant_hessian`` (squared error, h = 1) lets the loop drop the weight
channel when unsampled.  ``link_id`` is the serving ABI of the reference
(0 identity, 1 sigmoid, 2 softmax); the ids must stay stable.
``SoftmaxLoss`` keeps the reference's CLASS-FIRST ``[C, M]`` training
layout and CLASS-LAST ``[..., C]`` prediction layout.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SquaredLoss", "LogisticLoss", "SoftmaxLoss", "LOSSES",
           "get_loss"]


@dataclasses.dataclass(frozen=True)
class SquaredLoss:
    """L = 1/2 (raw - y)^2:  g = raw - y,  h = 1, identity link."""
    name = "squared"
    constant_hessian = True
    link_id = 0                  # identity (serving ABI)

    def base_score(self, y: torch.Tensor) -> torch.Tensor:
        return torch.mean(y)

    def grad_hess(self, y: torch.Tensor, raw: torch.Tensor):
        return raw - y, torch.ones_like(raw)

    def newton_target(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        # -g/h with h identically 1; no divide, as the reference
        return -g

    def link(self, raw: torch.Tensor) -> torch.Tensor:
        return raw


@dataclasses.dataclass(frozen=True)
class LogisticLoss:
    """Binary cross-entropy on raw log-odds, y in {0, 1}: with p =
    sigmoid(raw), g = p - y, h = max(p (1 - p), eps), sigmoid link.  The
    floor keeps ``z = -g/h`` finite when p saturates."""
    eps: float = 1e-6
    name = "logistic"
    constant_hessian = False
    link_id = 1                  # sigmoid (serving ABI)

    def base_score(self, y: torch.Tensor) -> torch.Tensor:
        p = torch.clamp(torch.mean(y), self.eps, 1.0 - self.eps)
        return torch.log(p) - torch.log1p(-p)

    def grad_hess(self, y: torch.Tensor, raw: torch.Tensor):
        p = torch.sigmoid(raw)
        return p - y, torch.clamp(p * (1.0 - p), min=self.eps)

    def newton_target(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return -g / h

    def link(self, raw: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(raw)


@dataclasses.dataclass(frozen=True)
class SoftmaxLoss:
    """Multiclass cross-entropy on per-class raw scores, y in {0..C-1}:
    with p = softmax(raw) over the class axis, g_c = p_c - [y = c] and
    h_c = max(p_c (1 - p_c), eps).  ``grad_hess`` / ``newton_target`` take
    the training loop's class-first ``[C, M]`` raw scores; ``link`` takes
    the prediction surface's class-last ``[..., C]``."""
    n_classes: int
    eps: float = 1e-6
    name = "softmax"
    constant_hessian = False
    is_multiclass = True
    link_id = 2                  # softmax, [B, C] (serving ABI)

    def __post_init__(self):
        if self.n_classes < 2:
            raise ValueError(
                f"SoftmaxLoss needs n_classes >= 2, got {self.n_classes}")

    def base_score(self, y: torch.Tensor) -> torch.Tensor:
        """Class log-priors [C]."""
        onehot = torch.nn.functional.one_hot(y.long(), self.n_classes)
        p = torch.clamp(onehot.to(torch.float32).mean(dim=0), self.eps, 1.0)
        return torch.log(p)

    def grad_hess(self, y: torch.Tensor, raw: torch.Tensor):
        """Per-class (g, h), both [C, M]; ``raw`` is class-first [C, M]."""
        p = torch.softmax(raw, dim=0)
        onehot = torch.nn.functional.one_hot(
            y.long(), self.n_classes).to(torch.float32).T          # [C, M]
        return p - onehot, torch.clamp(p * (1.0 - p), min=self.eps)

    def newton_target(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return -g / h

    def link(self, raw: torch.Tensor) -> torch.Tensor:
        """Class probabilities; ``raw`` is class-last [..., C]."""
        return torch.softmax(raw, dim=-1)


LOSSES = {"squared": SquaredLoss, "logistic": LogisticLoss,
          "softmax": SoftmaxLoss}


def get_loss(loss, **kwargs):
    """Resolve ``loss`` to a loss instance: a registered name (keyword
    arguments go to its class), a loss class or factory, or an instance
    (passed through; keyword arguments are then refused).  Unknown names
    raise ValueError listing the registry."""
    if isinstance(loss, str):
        try:
            cls = LOSSES[loss]
        except KeyError:
            raise ValueError(f"unknown loss {loss!r}; registered losses: "
                             f"{sorted(LOSSES)}") from None
        return cls(**kwargs)
    if isinstance(loss, type) or (callable(loss)
                                  and not hasattr(loss, "grad_hess")):
        return loss(**kwargs)
    if kwargs:
        raise ValueError("keyword arguments apply only when resolving a "
                         f"loss name or factory, not an instance: {loss!r}")
    return loss
