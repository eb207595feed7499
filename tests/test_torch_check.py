"""repro_torch.check: the recorder's exactly-once guarantee, every rule's
deliberate-violation path, the eleven contracts against the reference's
gate, the gate flipping on seeded mutations, a real gloo world's
collectives against the recording mesh's, and the repairs the gate forced
(bit for bit equal to the code they replaced).

Everything here records on the CPU (``device="cpu"``: fake ``cuda``
tensors, nothing runs); ``tests/test_torch_cuda.py`` runs the contracts on
the card."""
import collections

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.check import (BANNED_GATHER_PRIMS, COLLECTIVE_PRIMS,
                               CollectiveBudget, DTypePolicy, KernelBudget,
                               NoDynamicShapes, NoHostTransfer,
                               StaticBuffers, Surface, prim_of, record)
from repro_torch.check.cli import main, run_contracts
from repro_torch.check.contracts import registry, smoke_comm
from repro_torch.check.recorder import Launch
from repro_torch.core.collectives import Call, Collectives
from repro_torch.kernels import ops
from repro_torch.kernels.histogram import (histogram_plain, interleave_pairs,
                                           remap_slots)

CPU = "cpu"


# -- recorder: every op, collective and launch exactly once ----------------


def _build_nested(ops_):
    """Wrap a sin leaf in Python combinators outward-in; returns (fn,
    expected sin count, expected index count).  ``loop`` runs its body
    twice, ``index`` adds a gather through a method whose binding needs
    the device guard (``_FakeCuda``), ``call`` is a plain call."""
    fn = torch.sin
    n_sin, n_index = 1, 0
    for op in ops_:
        prev = fn
        if op == "loop":
            n_sin, n_index = 2 * n_sin, 2 * n_index

            def fn(x, prev=prev):
                for _ in range(2):
                    x = prev(x)
                return x
        elif op == "index":
            n_index += 1

            def fn(x, prev=prev):
                return prev(x)[torch.arange(x.shape[0], device=x.device)]
        else:
            def fn(x, prev=prev):
                return prev(x)
    return fn, n_sin, n_index


@pytest.mark.parametrize("ops_", [
    (), ("loop",), ("call", "index"), ("index", "loop", "call", "loop"),
    ("loop", "index", "index"), ("call", "call", "loop")])
def test_recorder_sees_each_op_exactly_once(ops_):
    fn, n_sin, n_index = _build_nested(ops_)
    s = record(fn, torch.ones(3), device=CPU)
    names = collections.Counter(o.name for o in s.ops)
    assert names["aten.sin.default"] == n_sin, names
    assert names["aten.index.Tensor"] == n_index, names
    # the fake device moves of _FakeCuda are not the program's
    assert names["aten._to_copy.default"] == 0
    assert not s.host and not s.dynamic
    assert s.result.device.type == "cuda" and s.result.shape == (3,)


def test_recorder_sees_each_collective_and_launch_exactly_once():
    comm = smoke_comm()

    def body(x, bins, stats, slot):
        for _ in range(3):
            x = comm.psum(x, ("data",), "t")
        comm.pmax(x.sum(), ("data", "model"), "t")
        ops.histogram(bins, stats, slot, num_slots=2, n_bins=4)
        ops.split_scan(torch.ones((2, 1, 4, 2), device=x.device),
                       torch.full((1,), 4, dtype=torch.int32,
                                  device=x.device),
                       torch.zeros((1,), dtype=torch.int32, device=x.device))
        return x

    ops.reset_launch_counts()
    s = record(body, torch.ones(4), torch.zeros((8, 1), dtype=torch.int32),
               torch.ones((8, 2)), torch.zeros(8, dtype=torch.int32),
               device=CPU, comm=comm)
    assert [(prim_of(c), c.tag) for c in s.collectives] == (
        [("psum", "t")] * 3 + [("pmax", "t")] * 2)
    assert [c.shape for c in s.collectives] == [(4,)] * 3 + [()] * 2
    assert s.launches == [Launch("histogram", ("plain",), None),
                          Launch("split_scan", ("info_gain",), None)]
    # a fake launch launches nothing, so nothing counts
    assert sum(ops.launch_counts().values()) == 0


# -- rules: one deliberate violation per rule ------------------------------


def _calls(*specs):
    """A surface holding the given collective calls (op, reduce, shape,
    dtype)."""
    return Surface(collectives=[Call(op, "t", 4, dt, shape, red)
                                for op, red, shape, dt in specs])


def test_collective_budget_bans_gathers():
    s = _calls(("all_gather_into_tensor", None, (4,), "float32"))
    viol = CollectiveBudget().check(s)
    assert any("banned collective: all_gather" in str(v) for v in viol)
    assert BANNED_GATHER_PRIMS < COLLECTIVE_PRIMS


def test_collective_budget_unlisted_collective_fails():
    """Any collective outside ``allowed`` is a violation, banned or not."""
    s = _calls(("all_reduce", "max", (), "float32"))
    assert CollectiveBudget().check(s)
    assert not CollectiveBudget({"pmax": 1}).check(s)


def test_collective_budget_catches_torch_distributed_past_collectives():
    def f(x):
        torch.distributed.all_reduce(x)
        return x

    s = record(f, torch.ones(4), device=CPU)
    viol = CollectiveBudget({"psum": 1}).check(s)
    assert any("banned collective: torch.distributed.all_reduce" in str(v)
               for v in viol)


def test_collective_budget_count_and_operand_specs():
    twice = _calls(("all_reduce", "sum", (), "float32"),
                   ("all_reduce", "sum", (), "float32"))
    viol = CollectiveBudget({"psum": 1}).check(twice)
    assert any("appears 2x, budget 1" in str(v) for v in viol)
    assert not CollectiveBudget({"psum": 2}).check(twice)
    # a loop of 2 steps may make its budget twice
    assert not CollectiveBudget({"psum": 1}, steps=2).check(twice)

    vec = _calls(("all_reduce", "sum", (4,), "float32"))
    assert any("must be scalar" in str(v) for v in CollectiveBudget(
        {"psum": dict(max=1, scalar=True)}).check(vec))
    assert any("> max_rank 0" in str(v) for v in CollectiveBudget(
        {"psum": dict(max_rank=0)}).check(vec))
    assert any("contract says int32" in str(v) for v in CollectiveBudget(
        {"psum": dict(dtype="int32")}).check(vec))
    # bulk cap counts operands at/above bulk_rank across allowed prims
    assert any("bulk collectives" in str(v) for v in CollectiveBudget(
        {"psum": dict()}, max_bulk=0, bulk_rank=1).check(vec))
    assert not CollectiveBudget(
        {"psum": dict(max=1, max_rank=1)}, max_bulk=1,
        bulk_rank=1).check(vec)


def test_no_host_transfer_flags_copies_reads_and_syncs():
    s = record(lambda x: x.cpu() + 1, torch.ones(3), device=CPU)
    assert any("device to host" in str(v) for v in NoHostTransfer().check(s))

    def sync(x):
        torch.cuda.synchronize()
        return x + 1

    s = record(sync, torch.ones(3), device=CPU)
    assert any("explicit sync" in str(v) for v in NoHostTransfer().check(s))
    # a host read of a value cannot be recorded on fake tensors: it raises
    for pull in (lambda x: x.sum().item(), lambda x: x.tolist(),
                 lambda x: np.asarray(x.cpu())):
        with pytest.raises(RuntimeError):
            record(pull, torch.ones(3), device=CPU)
    clean = record(torch.sin, torch.ones(3), device=CPU)
    assert not NoHostTransfer().check(clean)


def test_no_host_transfer_flags_host_to_device_copies():
    """On the card a blocking copy from the host syncs, and so does an
    index write of a Python number through a tensor index (the binding
    makes the number a host tensor); a scalar fill does not."""
    def index_write(x):
        t = torch.zeros(4, dtype=torch.bool, device=x.device)
        t[torch.arange(2, device=x.device)] = True
        return t

    def from_host(x):
        return x + torch.as_tensor(np.ones(3, np.float32), device=x.device)

    for fn in (index_write, from_host):
        s = record(fn, torch.ones(3), device=CPU)
        assert any("host to device" in str(v)
                   for v in NoHostTransfer().check(s)), fn
    fill = record(lambda x: torch.zeros(4, device=x.device).index_fill_(
        0, torch.arange(2, device=x.device), 1.0), torch.ones(3), device=CPU)
    assert not NoHostTransfer().check(fill)


def test_dtype_policy_catches_banned_dtype():
    s = record(lambda x: x.double().sum(), torch.ones(3), device=CPU)
    assert any("float64" in str(v) for v in DTypePolicy().check(s))
    s = record(lambda: torch.arange(4, dtype=torch.int32, device="cuda")
               .sum(dtype=torch.int32), device=CPU)
    assert any("int32" in str(v)
               for v in DTypePolicy(banned=("int32",)).check(s))
    assert not DTypePolicy().check(s)       # default bans f64/complex only


@pytest.mark.parametrize("dynamic", [
    lambda x: x.nonzero(), lambda x: x[x > 0], lambda x: x.masked_select(
        x > 0), lambda x: torch.unique(x)])
def test_no_dynamic_shapes_flags_data_dependent_outputs(dynamic):
    s = record(dynamic, torch.ones(4), device=CPU)
    viol = NoDynamicShapes().check(s)
    assert len(viol) == 1
    assert "data-dependent output shape" in str(viol[0])
    assert not NoDynamicShapes().check(
        record(lambda x: torch.where(x > 0, x, 0.0), torch.ones(4),
               device=CPU))


def test_static_buffers_needs_facts_and_a_graph_on_the_card():
    rule = StaticBuffers()
    assert any("no buffer facts" in str(v) for v in rule.check(Surface()))
    cpu_ok = Surface(device="cpu", facts=dict(buffers=dict(
        same_buffers=True, graph=None, replay_allocs=None)))
    assert not rule.check(cpu_ok)
    assert "n/a on cpu" in rule.unchecked(cpu_ok)
    moved = Surface(device="cpu", facts=dict(buffers=dict(
        same_buffers=False, graph=None, replay_allocs=None)))
    assert any("other buffers" in str(v) for v in rule.check(moved))
    card = Surface(device="cuda", facts=dict(buffers=dict(
        same_buffers=True, graph=False, replay_allocs=3)))
    viol = rule.check(card)
    assert any("no CUDA graph" in str(v) for v in viol)
    assert any("allocated 3 device blocks" in str(v) for v in viol)
    assert rule.unchecked(card) is None


def test_kernel_budget_caps_shared_memory():
    fits = Surface(device="cuda",
                   launches=[Launch("histogram", ("plain",), 73728)])
    assert not KernelBudget(232448, require_kernel="histogram").check(fits)
    viol = KernelBudget(1024).check(fits)
    assert any("> cap 1024 B" in str(v) for v in viol)
    bare = Surface(device="cuda")
    assert any("no histogram launch" in str(v) for v in
               KernelBudget(1024, require_kernel="histogram").check(bare))
    assert not KernelBudget(1024).check(bare)          # kernel optional
    fake = Surface(launches=[Launch("histogram", ("plain",), None)])
    assert not KernelBudget(require_kernel="histogram").check(fake)
    assert KernelBudget().unchecked(fake) == "shared memory n/a on cpu"


# -- the gate against the reference's ---------------------------------------


@pytest.fixture(scope="module")
def reference():
    """The reference's gate in this process (a 1x1 mesh unless more host
    devices exist), and each contract's collective counts by primitive."""
    from repro.check.cli import run_contracts as ref_run
    from repro.check.contracts import registry as ref_registry
    from repro.check.rules import COLLECTIVE_PRIMS as REF_PRIMS
    from repro.check.walker import iter_eqns
    results, n_fail = ref_run()
    counts = {}
    for name, con in ref_registry().items():
        counts[name] = collections.Counter(
            e.primitive.name
            for e in iter_eqns(con.build().jaxpr, enter_pallas=False)
            if e.primitive.name in REF_PRIMS)
    return {c.name: (v, e) for c, v, e in results}, n_fail, counts


@pytest.fixture(scope="module")
def port():
    results, n_fail = run_contracts(device=CPU)
    return results, n_fail, {c.name: s for c, _, _, _, s in results}


def test_the_eleven_contracts_in_the_reference_order(reference):
    verdicts, _, _ = reference
    assert [c.ref_name for c in registry().values()] == list(verdicts)
    assert len(registry()) == 11


@pytest.mark.parametrize("name", list(registry()))
def test_contract_holds_in_both_packages(reference, port, name):
    verdicts, _, ref_counts = reference
    results, _, surfaces = port
    con = registry()[name]
    v, e = verdicts[con.ref_name]
    assert not v and e is None, (con.ref_name, v, e)
    (got,) = [(viol, err) for c, viol, err, _, _ in results
              if c.name == name]
    assert got == ([], None), got
    # the port's collectives per mapped primitive (per step of a loop) are
    # at most the reference's; the declared exception is the grid's
    # all-gather over the model axis (the reference's out_specs)
    steps = max(getattr(r, "steps", 1) for r in con.rules)
    mine = collections.Counter(prim_of(c) for c in surfaces[name].collectives)
    for prim, n in mine.items():
        allowed = ref_counts[con.ref_name][prim]
        if name == "dist/grid-counts" and prim == "all_gather":
            allowed += 1
        assert n <= allowed * steps, (name, prim, n, allowed)


def test_cli_on_the_cpu_passes_with_card_only_parts_marked(capsys):
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("| ")
            and not ln.startswith("| contract") and not ln.startswith("| -")]
    assert [r.split(" | ")[0][2:] for r in rows] == list(registry())
    assert all(r.split(" | ")[3].startswith("pass") for r in rows), rows
    assert "shared memory n/a on cpu" in out
    assert "graph capture and replay allocations n/a on cpu" in out
    assert "all 11 contracts hold" in out


def test_cli_list_and_unmatched_only(capsys):
    assert main(["--list"]) == 0
    assert ("core/chunk-step-kernel (reference: core/chunk-step-pallas)"
            in capsys.readouterr().out)
    assert main(["--only", "no-such-contract-xyz", "--device", "cpu"]) == 1


def test_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--only", "core/chunk-step"])


# -- the gate flips on seeded mutations --------------------------------------


def test_gate_flips_on_psum_to_all_gather_mutation(monkeypatch, capsys):
    """Rerouting the grid's psum through an all-gather (replicate, then
    reduce) makes the gate exit nonzero."""
    def evil_psum(self, x, axes, tag):
        return self.all_gather(x[None], axes, tag).sum(0)

    monkeypatch.setattr(Collectives, "psum", evil_psum)
    assert main(["--only", "dist/grid-counts", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and "all_gather appears 2x, budget 1" in out


def test_gate_flips_on_host_pull_in_serve_walk(monkeypatch, capsys):
    """A ``.tolist()`` inside the routed walk cannot be recorded: the gate
    reports a trace error and exits nonzero."""
    import repro_torch.serve.registry as reg
    orig = reg.evaluate_predicate

    def evil(xb, nn, op, tbin):
        xb.tolist()                 # host materialisation inside the walk
        return orig(xb, nn, op, tbin)

    monkeypatch.setattr(reg, "evaluate_predicate", evil)
    assert main(["--only", "serve/routed-walk", "--device", "cpu"]) == 1
    assert "trace error" in capsys.readouterr().out.lower()


# -- a real gloo world makes the recording mesh's collectives ---------------

LEVEL_STEP_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.check.contracts import level_step_args
from repro_torch.core.collectives import Collectives

torch.set_num_threads(1)
rank, world, spec = int(sys.argv[1]), int(sys.argv[2]), json.load(open(sys.argv[3]))
tdist.init_process_group("gloo", init_method=spec["store"], rank=rank,
                         world_size=world)
try:
    mesh = init_device_mesh("cpu", tuple(spec["shape"]),
                            mesh_dim_names=tuple(spec["names"]))
    comm = Collectives(mesh)
    fn, args = level_step_args(comm)
    comm.log = []
    fn(*args)
    np.savez(f"{spec['out']}{rank}.npz")
    with open(f"{spec['out']}{rank}.json", "w") as fh:
        json.dump([[c.op, c.tag, c.dtype, list(c.shape)] for c in comm.log], fh)
finally:
    tdist.destroy_process_group()
"""


def test_gloo_world_makes_the_recorded_level_step_collectives(tmp_path):
    from _dist_worlds import start_world, wait_world
    handle = start_world(tmp_path, (2, 2), ("data", "model"), [],
                         tmp_path / "unused.npz", script=LEVEL_STEP_SCRIPT)
    _, logs = wait_world(handle)
    recorded = registry()["dist/level-step"].build(CPU).collectives
    assert logs[0] == [[c.op, c.tag, c.dtype, list(c.shape)]
                       for c in recorded]
    assert [c[:2] for c in logs[0]] == [
        ["all_reduce", "counts"], ["reduce_scatter_tensor", "hist"],
        ["all_gather_into_tensor", "select"],
        ["all_gather_into_tensor", "regather"]]
    # every rank makes the same calls
    assert all(log == logs[0] for log in logs)


# -- the repairs the gate forced: bit for bit the code they replaced --------


def _old_histogram_plain(bins, stats, slot, *, num_slots, n_bins,
                         weights=None, slot_map=None, phist=None, side=None):
    """``histogram_plain`` before the gate: a ``nonzero`` row filter."""
    m, k = bins.shape
    c = stats.shape[-1]
    if slot_map is not None:
        slot = remap_slots(slot, slot_map)
    if weights is not None:
        stats = stats * weights[:, None].to(stats.dtype)
    rows = ((slot >= 0) & (slot < num_slots)).nonzero()[:, 0]
    feat = torch.arange(k, device=bins.device)
    idx = ((slot[rows].long()[:, None] * k + feat) * n_bins
           + bins[rows].long())
    h = torch.zeros((num_slots * k * n_bins, c), dtype=stats.dtype,
                    device=bins.device)
    h.index_add_(0, idx.reshape(-1),
                 stats[rows][:, None, :].expand(-1, k, -1).reshape(-1, c))
    h = h.view(num_slots, k, n_bins, c)
    return h if phist is None else interleave_pairs(h, phist, side)


@pytest.mark.parametrize("m", [50, 4000, 60000])
@pytest.mark.parametrize("mode", ["plain", "weights", "slot_map", "fused"])
def test_static_histogram_plain_equals_the_masked_form(mode, m):
    rng = np.random.default_rng(m)
    k, b, c, s = 5, 17, 3, 8
    bins = torch.as_tensor(rng.integers(0, b, (m, k)), dtype=torch.int32)
    stats = torch.as_tensor(rng.normal(size=(m, c)), dtype=torch.float32)
    # slots -1 and num_slots (and beyond) must drop their rows
    slot = torch.as_tensor(rng.integers(-1, s + 2, m), dtype=torch.int32)
    kw = dict(num_slots=s, n_bins=b)
    if mode == "weights":
        kw["weights"] = torch.as_tensor(rng.uniform(size=m),
                                        dtype=torch.float32)
    if mode in ("slot_map", "fused"):
        kw["slot_map"] = torch.as_tensor(rng.integers(-1, s // 2, s + 2),
                                         dtype=torch.int32)
        kw["num_slots"] = s // 2
    if mode == "fused":
        kw["phist"] = torch.as_tensor(rng.normal(size=(s // 2, k, b, c)),
                                      dtype=torch.float32)
        kw["side"] = torch.as_tensor(rng.integers(0, 2, s // 2),
                                     dtype=torch.int32)
    want = _old_histogram_plain(bins, stats, slot, **kw)
    got = histogram_plain(bins, stats, slot, **kw)
    assert torch.equal(got, want)
    assert (slot == s).any() and (slot == -1).any()


def _old_grid_counts(lab, cnt, cmc, y, valid, smin, mcw, dmax, *,
                     classification=True):
    """``tuning._grid_counts`` before the gate: a host loop over
    ``dmax.tolist()``."""
    from repro_torch.core.tuning import _stop
    ns, nw = smin.shape[0], mcw.shape[0]
    stop = _stop(cnt, cmc, smin, mcw)
    out = []
    for d in dmax.tolist():
        pred = _old_labels_at(lab, stop, d).reshape(-1, ns, nw)
        if classification:
            ok = (pred == y[:, None, None]) & valid[:, None, None]
            out.append(ok.sum(dim=0).to(torch.int32))
        else:
            err = torch.where(valid[:, None, None],
                              (pred - y[:, None, None]) ** 2, 0.0)
            out.append(err.sum(dim=0))
    return torch.stack(out)


def _old_labels_at(lab, stop, d):
    m, t_len = lab.shape
    idx = stop.clamp(max=d - 1).clamp(0, t_len - 1)
    return torch.gather(lab, 1, idx.reshape(m, -1).long())


def _old_ensemble_grid_counts(tables, y, valid, smin, mcw, dmax, lr, base, *,
                              logistic=True):
    from repro_torch.core.tuning import _stop
    nd, ns, nw = dmax.shape[0], smin.shape[0], mcw.shape[0]
    m = y.shape[0]
    raw = base.expand(nd, m, ns * nw)
    outs = []
    for lab, cnt, cmc in tables:
        stop = _stop(cnt, cmc, smin, mcw)
        contrib = torch.stack([_old_labels_at(lab, stop, d)
                               for d in dmax.tolist()])
        raw = raw + lr * contrib
        if logistic:
            ok = (raw > 0) == (y[None, :, None] > 0.5)
            outs.append((ok & valid[None, :, None]).sum(dim=1)
                        .to(torch.int32))
        else:
            err = torch.where(valid[None, :, None],
                              (raw - y[None, :, None]) ** 2, 0.0)
            outs.append(err.sum(dim=1))
    return torch.stack(outs).reshape(len(tables), nd, ns, nw)


def _grid_inputs(seed, integer):
    rng = np.random.default_rng(seed)
    m, t = 300, 6
    lab = (rng.integers(0, 3, (m, t)) if integer
           else rng.normal(size=(m, t)))
    y = rng.integers(0, 3, m) if integer else rng.normal(size=m)
    return dict(
        lab=torch.as_tensor(lab, dtype=torch.float32),
        cnt=torch.as_tensor(np.sort(rng.integers(1, 90, (m, t)))[:, ::-1]
                            .copy(), dtype=torch.int32),
        cmc=torch.as_tensor(np.sort(rng.uniform(0, 9, (m, t)))[:, ::-1]
                            .copy(), dtype=torch.float32),
        y=torch.as_tensor(y, dtype=torch.float32),
        valid=torch.as_tensor(rng.uniform(size=m) < 0.9),
        smin=torch.as_tensor([0, 2, 8, 40], dtype=torch.int32),
        mcw=torch.as_tensor([0.0, 1.0, 4.5], dtype=torch.float32),
        dmax=torch.as_tensor([1, 3, 5, 9], dtype=torch.int32))


@pytest.mark.parametrize("integer", [True, False])
def test_grid_counts_without_host_reads_equal_the_old_loop(integer):
    from repro_torch.core.tuning import _ensemble_grid_counts, _grid_counts
    g = _grid_inputs(11, integer)
    args = [g[f] for f in ("lab", "cnt", "cmc", "y", "valid", "smin", "mcw",
                           "dmax")]
    for cls in (True, False):
        assert torch.equal(_grid_counts(*args, classification=cls),
                           _old_grid_counts(*args, classification=cls))
    tables = [(g["lab"], g["cnt"], g["cmc"]),
              tuple(_grid_inputs(12, integer)[f] for f in ("lab", "cnt",
                                                            "cmc"))]
    rest = [g[f] for f in ("y", "valid", "smin", "mcw", "dmax")]
    lr, base = torch.tensor(0.3), torch.tensor(-0.1)
    for logistic in (True, False):
        assert torch.equal(
            _ensemble_grid_counts(tables, *rest, lr, base, logistic=logistic),
            _old_ensemble_grid_counts(tables, *rest, lr, base,
                                      logistic=logistic))
