"""Port parity: repro_torch.core.heuristics against repro.core.heuristics
(rtol 1e-6) on random class-count and moment blocks, empty sides included."""
import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from repro.core import heuristics as jh
from repro_torch.core import heuristics as th


def _blocks(seed, c):
    rng = np.random.default_rng(seed)
    pos = rng.poisson(3, size=(64, c)).astype(np.float32)
    neg = rng.poisson(3, size=(64, c)).astype(np.float32)
    pos[:4] = 0                                     # empty positive side
    neg[4:8] = 0                                    # empty negative side
    pos[8, 1:] = 0                                  # pure sides
    if c >= 3:
        # moment rows for sse: (count, sum_y, sum_y2)
        mu = rng.normal(size=64).astype(np.float32)
        for a in (pos, neg):
            a[:, 1] = a[:, 0] * mu
            a[:, 2] = a[:, 0] * (mu * mu + 0.5)
    return pos, neg


@pytest.mark.parametrize("name", ["info_gain", "gini", "chi_square", "sse"])
@pytest.mark.parametrize("c", [2, 3, 5])
def test_heuristic_matches_reference(name, c):
    pos, neg = _blocks(c, c)
    want = np.asarray(jh.get(name)(jnp.asarray(pos), jnp.asarray(neg)))
    got = th.get(name)(torch.from_numpy(pos), torch.from_numpy(neg)).numpy()
    # rtol 1e-6; values that cancel to ~0 (independent tables under
    # chi-square) get the same 1e-6 relative to the block's largest value
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_registry_and_codes():
    assert list(th.HEURISTICS) == list(jh.HEURISTICS)
    assert th.HEURISTIC_CODES == {"info_gain": 0, "gini": 1, "chi_square": 2,
                                  "sse": 3}
    with pytest.raises(ValueError):
        th.get("entropy")
