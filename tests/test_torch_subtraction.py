"""Sibling subtraction in the PyTorch port against the reference package:
the port's fused call given no ``compute`` mask picks the smaller children
itself (its local level step; on the ``kernel`` backend the ``pairs`` mode,
whose plain version runs on the CPU)."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import node_histogram_sibling_fused
from repro_torch.core import node_histogram_sibling_fused as port_fused
from test_subtraction import _fused_case_inputs


@pytest.mark.parametrize("backend", ["segment", "onehot", "kernel"])
@pytest.mark.parametrize("kind", ["class", "moment"])
@pytest.mark.parametrize("seed", range(3))
def test_port_picks_the_smaller_children_without_a_mask(backend, kind, seed):
    """The port's fused call given no mask against the reference's fused
    call given the smaller-child mask (empty and one-sided pairs, ties,
    inactive rows): equal for class counts, the fused tolerance for float
    moments."""
    rng = np.random.default_rng(300 + seed)
    pairs, k, b, c = int(rng.integers(2, 9)), 3, 11, 4
    bins, stats, slot, compute, h_parent = _fused_case_inputs(
        rng, int(rng.integers(50, 800)), pairs, k, b, c,
        skew=float(rng.uniform(0, 0.45)), empty_frac=0.3, kind=kind)
    s = 2 * pairs
    want = node_histogram_sibling_fused(bins, stats, slot, compute,
                                        h_parent, num_slots=s, n_bins=b,
                                        backend="segment")
    got = port_fused(*(torch.from_numpy(np.array(x))
                       for x in (bins, stats, slot)), None,
                     torch.from_numpy(np.array(h_parent)), num_slots=s,
                     n_bins=b, backend=backend)
    if kind == "class":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(got.numpy()[..., 0],
                                      np.asarray(want)[..., 0])
