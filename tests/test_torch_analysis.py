"""The dry run's roofline arithmetic and counting recording
(``repro_torch.launch.analysis``) against the reference's
(``repro.launch.analysis``).

* ``Roofline.terms``, ``corrected`` and ``serve_seconds_lower_bound`` on
  seeded inputs equal the reference's exactly once the port's H100
  constants are patched to the reference's TPU ones; with the port's own
  constants they give the hand-worked numbers of ``tests/test_analysis.py``
  with the constants swapped.
* ``model_flops`` equals the reference's on all ten configs.
* ``collective_bytes`` of a ``Collectives.log`` holding the five calls of
  ``tests/test_analysis.py::HLO`` equals the reference's parse of that HLO,
  key for key.
* ``count``: the FLOPs of a dense smoke forward equal the hand count of its
  products, and a fake recording counts what a real run on the same shapes
  counts.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch import analysis as ja
from repro_torch import configs
from repro_torch.core.collectives import Call, RecordingCollectives
from repro_torch.launch import analysis as A
from repro_torch.launch import specs
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.train import init_train_state, make_train_step

MEM0 = {"argument_bytes": 0, "output_bytes": 0, "temp_bytes": 0,
        "alias_bytes": 0}


@pytest.fixture
def reference_constants(monkeypatch):
    monkeypatch.setattr(A, "PEAK_FLOPS", ja.PEAK_FLOPS)
    monkeypatch.setattr(A, "HBM_BW", ja.HBM_BW)
    monkeypatch.setattr(A, "LINK_BW", ja.ICI_BW)


@pytest.mark.parametrize("seed", range(4))
def test_terms_equal_reference(seed, reference_constants):
    rng = np.random.default_rng(seed)
    f, b, c = (float(x) for x in rng.uniform(1e9, 1e15, size=3))
    for chips, per_device in ((1, True), (256, True), (512, False)):
        got = A.Roofline(f, b, c, chips, per_device).terms()
        want = ja.Roofline(f, b, c, chips, per_device).terms()
        assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_corrected_and_serve_bound_equal_reference(seed,
                                                   reference_constants):
    rng = np.random.default_rng(seed)

    def mk():
        f, b, c = (float(x) for x in rng.uniform(0, 1e12, size=3))
        return {"flops": f, "bytes_accessed": b,
                "collectives": {"total": c}, "memory": dict(MEM0),
                "chips": 256}

    raw, b1, b2 = mk(), mk(), mk()
    n = int(rng.integers(1, 40))
    assert A.corrected(raw, b1, b2, n) == ja.corrected(raw, b1, b2, n)
    w, r = (float(x) for x in rng.uniform(1, 1e6, size=2))
    for chips in (1, 4):
        assert (A.serve_seconds_lower_bound(w, r, chips)
                == ja.serve_seconds_lower_bound(w, r, chips))


def test_scan_depth_correction():
    mk = lambda f, b, c: {"flops": f, "bytes_accessed": b,  # noqa: E731
                          "collectives": {"total": c}, "memory": dict(MEM0)}
    out = A.corrected(mk(100.0, 1000.0, 10.0), mk(30.0, 300.0, 3.0),
                      mk(50.0, 500.0, 5.0), n_groups=11)
    assert out["flops"] == pytest.approx(100 + 10 * 20)
    assert out["bytes_accessed"] == pytest.approx(1000 + 10 * 200)
    assert out["collective_bytes_corrected"] == pytest.approx(10 + 10 * 2)


def test_roofline_terms_and_bottleneck_h100():
    r = A.Roofline(flops=989e12, bytes_accessed=3.35e12 * 2,
                   coll_bytes=50e9 * 0.5, chips=256)
    t = r.terms()
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["bottleneck"] == "memory"
    assert t["step_lower_bound_s"] == pytest.approx(2.0)
    assert A.serve_seconds_lower_bound(3.35e12, 2.0, chips=2) == \
        pytest.approx(1.0)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_equal_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for kind in ("train", "decode", "prefill"):
        assert (A.model_flops(cfg, kind, 1000)
                == ja.model_flops(jcfg, kind, 1000))
    if arch == "arctic_480b":
        assert cfg.active_param_count() < cfg.param_count() / 10


HLO = """
HloModule jit_step
ENTRY main {
  %p0 = f32[16,128]{1,0} parameter(0)
  %ar = f32[16,128]{1,0} all-reduce(f32[16,128]{1,0} %p0), replica_groups={}
  %ag = bf16[64,256]{1,0} all-gather(bf16[8,256]{1,0} %x), dimensions={0}
  %rs = f32[2,128]{1,0} reduce-scatter(f32[16,128]{1,0} %p0), dimensions={0}
  %a2a = f32[4,32]{1,0} all-to-all(f32[4,32]{1,0} %y), dimensions={0}
  %cp = s32[100]{0} collective-permute(s32[100]{0} %z)
  ROOT %t = (f32[16,128]{1,0}) tuple(%ar)
}
"""     # tests/test_analysis.py::HLO

# its five calls as Collectives logs them
HLO_LOG = [
    Call("all_reduce", "t", 16 * 128 * 4, "float32", (16, 128), "sum", 8),
    Call("all_gather_into_tensor", "t", 8 * 256 * 2, "bfloat16", (8, 256),
         None, 8),
    Call("reduce_scatter_tensor", "t", 16 * 128 * 4, "float32", (16, 128),
         "sum", 8),
    Call("all_to_all_single", "t", 4 * 32 * 4, "float32", (4, 32), None, 4),
    Call("collective_permute", "t", 100 * 4, "int32", (100,), None, 2),
]


def test_collective_bytes_equal_reference_parse():
    assert A.collective_bytes(HLO_LOG) == ja.collective_bytes(HLO)
    assert A.collective_bytes([]) == ja.collective_bytes("")
    one_rank = [c._replace(group=1) for c in HLO_LOG]
    assert A.collective_bytes(one_rank) == ja.collective_bytes("")
    with pytest.raises(ValueError):
        A.collective_bytes([Call("broadcast", "t", 4, "float32", (1,))])


def _hand_flops(cfg, b, t):
    """2 * m * n * k of every product of a dense forward (no mesh)."""
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                       cfg.d_ff)
    tok = b * t
    proj = 2 * tok * d * hd * (2 * h + 2 * kv)          # q, o; k, v
    attn = 2 * 2 * b * h * t * t * hd                    # logits, p @ v
    ffn = 3 * 2 * tok * d * f                             # gate, up, down
    return cfg.n_layers * (proj + attn + ffn) + 2 * tok * d * cfg.vocab


def test_counted_flops_of_a_dense_forward_equal_the_hand_count():
    cfg = configs.get_smoke("smollm_360m")
    b, t = 2, 8
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    state = specs.fake_state(cfg, mode)
    batch = specs.fake_inputs({"tokens": torch.empty((b, t),
                                                     dtype=torch.int32,
                                                     device="meta")}, mode)
    with mode, torch.no_grad():
        got = A.count(M.forward, state.model, batch)
    assert got["flops"] == _hand_flops(cfg, b, t)
    assert got["log"] == [] and got["collectives"]["total"] == 0
    assert got["memory"]["alias_bytes"] == 0
    assert got["memory"]["output_bytes"] == b * t * cfg.vocab * 2   # bf16


def test_fake_recording_counts_what_a_real_run_counts():
    """The train step of a smoke config, once on fake CPU tensors and once
    on real ones: every count equal; the parameters and moments are
    written in place, so they are aliased outputs."""
    cfg = configs.get_smoke("smollm_360m")
    tree = specs.input_specs(cfg, "train_4k", seq=16)
    tree = {k: torch.empty((2, 16), dtype=v.dtype, device="meta")
            for k, v in tree.items()}
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fake_state = specs.fake_state(cfg, mode)
    fake_batch = specs.fake_inputs(tree, mode)
    step = make_train_step(cfg)
    with mode:
        fake = A.count(step, fake_state, fake_batch)
    g = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, g, device="cpu")
    batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=g,
                              dtype=v.dtype) for k, v in tree.items()}
    real = A.count(step, state, batch)
    for k in ("flops", "bytes_accessed", "collectives", "memory", "ops"):
        assert fake[k] == real[k], k
    params = sum(p.numel() * 4 for p in state.model.parameters())
    assert real["memory"]["alias_bytes"] == 3 * params   # params, m, v
    assert real["memory"]["argument_bytes"] == 3 * params + 4 + 2 * 2 * 16 * 4
    assert real["flops"] > 0 and real["memory"]["temp_bytes"] > params


def test_recording_collectives_are_logged_not_counted_as_traffic():
    """A tiled all-gather over a 2-rank recording axis: logged once with
    its group, its ring bytes the gathered output; the stand-in copy that
    answers it moves no counted byte (the op around it is views and an
    allocation)."""
    comm = RecordingCollectives((("data", 2),))
    x = torch.ones((4, 3))
    got = A.count(lambda t: comm.all_gather(t, ("data",), "t"), x,
                  comm=comm)
    assert comm.log == [] and len(got["log"]) == 1
    assert got["log"][0].group == 2
    assert got["collectives"]["all-gather"] == 2 * 4 * 3 * 4
    assert got["bytes_accessed"] == 0
    assert got["memory"]["output_bytes"] == 2 * 4 * 3 * 4


def test_sharded_forward_logs_its_collectives():
    """The dense smoke forward on a 1x1 recording mesh: one ``attn`` and
    one ``ffn`` psum a layer, one ``embed`` psum, one ``logits`` gather;
    among one rank each, so no ring traffic."""
    cfg = configs.get_smoke("smollm_360m")
    comm = RecordingCollectives((("data", 1), ("model", 1)))
    axes = SH.MeshAxes(data=("data",), model="model",
                       sizes={"data": 1, "model": 1})
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    state = specs.fake_state(cfg, mode, comm=comm, axes=axes)
    batch = specs.fake_inputs({"tokens": torch.empty(
        (2, 8), dtype=torch.int32, device="meta")}, mode)
    SH.set_activation_axes(axes, comm=comm)
    try:
        with mode, torch.no_grad():
            got = A.count(M.forward, state.model, batch, comm=comm)
    finally:
        SH.set_activation_axes(None)
    assert {c.group for c in got["log"]} == {1}
    ops = [(c.op, c.tag) for c in got["log"]]
    assert sorted(set(ops)) == sorted({("all_reduce", "embed"),
                                       ("all_reduce", "attn"),
                                       ("all_reduce", "ffn"),
                                       ("all_gather_into_tensor", "logits")})
    assert ops.count(("all_reduce", "attn")) == cfg.n_layers
    assert ops.count(("all_reduce", "ffn")) == cfg.n_layers
    assert got["collectives"]["total"] == 0
