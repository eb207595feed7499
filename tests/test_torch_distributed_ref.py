"""The port's sharded build on a 2x2 gloo world against the reference's own
sharded build on 4 forced host devices, field for field.

The reference runs in a subprocess (``XLA_FLAGS`` must be set before jax is
imported) on a plain ``jax.sharding.Mesh`` of 2x2 ("data", "model"):
``jax.make_mesh`` gives explicit axes under jax 0.9, and the reference's
parent-cache gather then raises ``ShardingTypeError``.  Both builds take the
reference SCRIPT's data and the composed and ``slot_scatter=False``
layouts; the split score, a float heuristic of each package's own log, is
held to rtol 1e-6."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fit_bins  # noqa: E402
from repro.data import make_classification  # noqa: E402
from repro_torch.core.tree import TREE_FIELDS  # noqa: E402

from _dist_worlds import SRC, run_world  # noqa: E402

LAYOUTS = {"composed": {}, "psum_sub": dict(slot_scatter=False)}
CFG = dict(max_depth=10, chunk_slots=64, task="classification")

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core import BinnedTable, TreeConfig
from repro.core.distributed import DistConfig, build_tree_distributed

assert len(jax.devices()) == 4
d = np.load(sys.argv[1])
table = BinnedTable(bins=d["cls/bins"], n_num=d["cls/n_num"],
                    n_cat=d["cls/n_cat"], metas=[], n_bins=int(d["cls/n_bins"]))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for name, kw in %(layouts)r.items():
    t = build_tree_distributed(table, d["cls/y"], TreeConfig(**%(cfg)r),
                               mesh=mesh, dist=DistConfig(**kw), n_classes=3)
    out[name + "/n_nodes"] = np.int64(t.n_nodes)
    for f in %(fields)r:
        out[name + "/" + f] = np.asarray(getattr(t, f))[:t.n_nodes]
np.savez(sys.argv[2], **out)
""" % {"layouts": LAYOUTS, "cfg": CFG, "fields": TREE_FIELDS}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ref")
    cols, y = make_classification(600, 7, 3, seed=9, n_cat_features=2,
                                  missing_frac=0.02)
    table = fit_bins(cols, max_num_bins=32)
    data = tmp / "problem.npz"
    np.savez(data, **{"cls/bins": np.asarray(table.bins),
                      "cls/n_num": np.asarray(table.n_num),
                      "cls/n_cat": np.asarray(table.n_cat),
                      "cls/n_bins": int(table.n_bins), "cls/y": np.asarray(y)})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(data),
                            str(tmp / "ref.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        cases = [dict(name=name, problem="cls", y="cls/y", n_classes=3,
                      cfg=CFG, dist=dict(data_axes=["data"],
                                         model_axis="model", **kw))
                 for name, kw in LAYOUTS.items()]
        port, _ = run_world(tmp / "world", (2, 2), ("data", "model"), cases,
                            data)
        log = ref.communicate(timeout=120)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-4000:]
    return port, dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_world_equals_reference_sharded_build(both, layout):
    port, ref = both
    got = port[layout][0]
    assert int(got["n_nodes"]) == int(ref[f"{layout}/n_nodes"]) > 50
    for f in TREE_FIELDS:
        want = ref[f"{layout}/{f}"]
        assert got[f].dtype == want.dtype, f
        if f == "score":
            np.testing.assert_allclose(got[f], want, rtol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)
