"""Port parity for the boosting losses (repro_torch.core.losses) on the CPU
against repro.core.losses: ``base_score``, ``grad_hess``, ``newton_target``
and ``link`` agree within rtol/atol 1e-6 (sigmoid, softmax and log are
evaluated by different libraries), and the registry resolves the same
way."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro_torch.core import losses as tl

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(name, seed):
    """(y, raw): labels and raw scores of each loss's layout, from a seed;
    raw scores reach +-12 so that the logistic hessian floor is hit."""
    rng = np.random.default_rng(seed)
    m = 257
    if name == "squared":
        return (rng.normal(size=m).astype(np.float32),
                rng.normal(scale=3.0, size=m).astype(np.float32))
    if name == "logistic":
        return (rng.integers(0, 2, m).astype(np.float32),
                rng.uniform(-12, 12, m).astype(np.float32))
    return (rng.integers(0, 4, m).astype(np.int32),
            rng.uniform(-12, 12, (4, m)).astype(np.float32))


def _make(pkg, name):
    return pkg.get_loss(name, n_classes=4) if name == "softmax" else pkg.get_loss(name)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["squared", "logistic", "softmax"])
def test_loss_pieces_equal(name, seed):
    y, raw = _inputs(name, seed)
    jlo, tlo = _make(jl, name), _make(tl, name)
    assert (tlo.name, tlo.link_id, tlo.constant_hessian) == (
        jlo.name, jlo.link_id, jlo.constant_hessian)
    _close(tlo.base_score(torch.from_numpy(y)), jlo.base_score(jnp.asarray(y)))
    g, h = tlo.grad_hess(torch.from_numpy(y), torch.from_numpy(raw))
    jg, jh = jlo.grad_hess(jnp.asarray(y), jnp.asarray(raw))
    _close(g, jg)
    _close(h, jh)
    _close(tlo.newton_target(g, h), jlo.newton_target(jg, jh))
    last = raw.T if name == "softmax" else raw   # link takes class-last
    _close(tlo.link(torch.from_numpy(np.ascontiguousarray(last))),
           jlo.link(jnp.asarray(last)))


def test_get_loss_resolves_like_the_reference():
    assert isinstance(tl.get_loss("logistic"), tl.LogisticLoss)
    assert tl.get_loss("softmax", n_classes=5).n_classes == 5
    assert tl.get_loss(tl.SoftmaxLoss, n_classes=3).n_classes == 3
    inst = tl.LogisticLoss(eps=1e-3)
    assert tl.get_loss(inst) is inst
    assert sorted(tl.LOSSES) == sorted(jl.LOSSES)
    with pytest.raises(ValueError, match="registered losses"):
        tl.get_loss("hinge")
    with pytest.raises(ValueError, match="keyword arguments"):
        tl.get_loss(inst, eps=1.0)
    with pytest.raises(ValueError, match="n_classes >= 2"):
        tl.SoftmaxLoss(n_classes=1)
