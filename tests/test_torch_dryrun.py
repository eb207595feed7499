"""The dry run (``repro_torch.launch.dryrun``) against the reference's cells
and arithmetic, at smoke sizes.

* Every (arch, shape) cell's row: a SKIP row with the reference's reason
  (``repro.configs.cells()``) where it skips, else OK with the reference's
  row fields (one pattern group of the smoke config on a 2x2 recording
  mesh at a short length: the whole dry run is a full-width job of its
  own).
* Every cell is recorded whole: the sLSTM's and the RG-LRU's recurrence
  is one op each way (``repro_torch::linear_scan``), so a train step of
  xlstm-smoke or recurrentgemma-smoke dispatches as many ops at 64
  positions as at 32 (one mLSTM chunk either way), the op's counted bytes
  are its operands' (3 B T D 4 forward, 5 B T D 4 backward), and a
  recurrent cell of each model records OK on a 2x2 mesh at a longer
  length.
* A decode step's collectives on a 2x2 recording mesh follow from the layer
  count and widths: one ``embed`` psum a step, one ``attn`` and one
  ``ffn`` psum a layer, one ``logits`` all-gather a step.
* The UDT cell at a reduced m and k on a 2x2 recording mesh: the histogram
  collective hands in the reference's per-chunk bytes (S x K_l x B x C x 4,
  the arithmetic phase ``dist`` holds against ``builder.chunks``), and the
  fake recording counts what a real CPU run of the step counts.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.core.distributed import DistConfig, make_sharded_step
from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.launch import analysis, dryrun

SMALL_SHAPES = {"train_4k": (16, 4, "train"),
                "prefill_32k": (16, 2, "prefill"),
                "decode_32k": (16, 4, "decode"),
                "long_500k": (32, 1, "decode")}
ROW_FIELDS = {"arch", "shape", "mesh", "chips", "status", "lower_compile_s",
              "flops", "bytes_accessed", "collectives", "memory",
              "compute_s", "memory_s", "collective_s", "bottleneck",
              "step_lower_bound_s", "model_flops_global",
              "hlo_flops_global", "model_vs_hlo", "collective_calls"}


def _one_group(arch):
    """The smoke config cut to one pattern group: one layer of each
    kind."""
    cfg = configs.get_smoke(arch)
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern))


@pytest.fixture
def mesh_2x2(monkeypatch):
    monkeypatch.setitem(dryrun.MESHES, "2x2", (("data", 2), ("model", 2)))
    return "2x2"


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_rows_equal_reference_cells(arch, mesh_2x2, monkeypatch):
    ref = {s: why for a, s, why in jconfigs.cells() if a == arch}
    assert list(ref) == list(configs.SHAPES)
    for shape, why in ref.items():
        if why:
            row = dryrun.run_cell(arch, shape, "16x16", verbose=False)
            assert row["status"] == f"SKIP({why})"
            assert row["chips"] == 256
    monkeypatch.setattr(configs, "get", _one_group)
    monkeypatch.setattr(configs, "SHAPES", SMALL_SHAPES)
    for shape, why in ref.items():
        if why:
            continue
        row = dryrun.run_cell(arch, shape, mesh_2x2, verbose=False)
        assert row["status"] == "OK", row.get("traceback")
        assert ROW_FIELDS <= set(row), ROW_FIELDS - set(row)
        assert row["chips"] == 4
        assert row["flops"] > 0 and row["bytes_accessed"] > 0
        assert row["hlo_flops_global"] == 4 * row["flops"]
        assert row["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("arch", ["xlstm_125m", "recurrentgemma_2b"])
def test_train_step_ops_do_not_grow_with_the_length(arch, mesh_2x2):
    """No loop over positions is left: the smoke config's train step on a
    2x2 recording mesh dispatches as many ops at 64 positions as at 32
    (one mLSTM chunk, one CE chunk either way), and moves more bytes."""
    cfg = configs.get_smoke(arch)

    def rec(n):
        return dryrun.record_cell(cfg, "train_4k", *dryrun.production_comm(
            mesh_2x2), seq=n)

    short, long_ = rec(32), rec(64)
    assert short["ops"] == long_["ops"]
    assert long_["bytes_accessed"] > short["bytes_accessed"]
    assert [(c.op, c.tag) for c in short["log"]] == [
        (c.op, c.tag) for c in long_["log"]]


@pytest.mark.parametrize("fake", [False, True])
def test_linear_scan_counts_its_operands_bytes(fake):
    """One op forward, 3 B T D 4 bytes (a, b read, h written); one op
    backward, 5 B T D 4 bytes (a, h, g read, da, db written); on real and
    on fake CPU tensors alike."""
    b_, t, d = 2, 48, 24
    rng = np.random.default_rng(0)
    arrays = [torch.from_numpy(rng.uniform(0.1, 0.9, size=(b_, t, d))
                               .astype(np.float32)) for _ in range(3)]
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else None
    if fake:
        arrays = [mode.from_tensor(x) for x in arrays]
    a, x, g = arrays
    a.requires_grad_()
    unit = b_ * t * d * 4
    with mode or contextlib.nullcontext():
        with torch.no_grad():
            fwd = analysis.count(linear_scan, a, x)
        h = linear_scan(a, x)
        bwd = analysis.count(torch.autograd.grad, h, a, g)
    assert (fwd["ops"], fwd["bytes_accessed"]) == (1, 3 * unit)
    assert (bwd["ops"], bwd["bytes_accessed"]) == (1, 5 * unit)
    assert fwd["flops"] == bwd["flops"] == 0


@pytest.mark.parametrize("arch", ["xlstm_125m", "recurrentgemma_2b"])
def test_recurrent_cell_is_recorded_whole(arch, mesh_2x2, monkeypatch):
    """The smoke config's train cell at 256 positions on a 2x2 recording
    mesh: OK, recorded whole (its collectives listed), the recurrent
    blocks on their width slices (the sLSTM's gate exchange, the RG-LRU's
    psum)."""
    monkeypatch.setattr(configs, "get", configs.get_smoke)
    monkeypatch.setitem(configs.SHAPES, "train_4k", (256, 4, "train"))
    row = dryrun.run_cell(arch, "train_4k", mesh_2x2, verbose=False)
    assert row["status"] == "OK", row.get("traceback")
    assert row["memory_s"] > 0 and row["compute_s"] > 0
    want = ("all_to_all_single/slstm" if arch == "xlstm_125m"
            else "all_reduce/rglru")
    assert row["collective_calls"][want][0] > 0, row["collective_calls"]


def test_decode_collectives_follow_the_layer_count(mesh_2x2, monkeypatch):
    """codeqwen-smoke (4 heads, 4 kv heads, d_ff and vocab divide 2): the
    heads path, so every collective of a decode step is a psum of the
    ``[B_loc, 1, D]`` residual or the logits' gather over the vocab."""
    cfg = configs.get_smoke("codeqwen15_7b")
    comm, axes = dryrun.production_comm(mesh_2x2)
    monkeypatch.setitem(configs.SHAPES, "decode_32k", (16, 4, "decode"))
    got = dryrun.record_cell(cfg, "decode_32k", comm, axes)
    # the psums carry the f32 products of bf16 activations and f32
    # weights (``layers.einsum``); the logits are gathered in bf16
    b_loc = 4 // 2
    row = b_loc * cfg.d_model * 4
    logits = b_loc * cfg.vocab // 2 * 2
    want = ([("all_reduce", "embed", row)]
            + [("all_reduce", "attn", row), ("all_reduce", "ffn", row)]
            * cfg.n_layers
            + [("all_gather_into_tensor", "logits", logits)])
    assert [(c.op, c.tag, c.nbytes) for c in got["log"]] == want
    assert {c.group for c in got["log"]} == {2}
    assert got["collectives"]["all-reduce"] == 2 * row * (
        1 + 2 * cfg.n_layers)
    assert got["collectives"]["all-gather"] == 2 * logits


def test_udt_cell_collectives_follow_the_chunk_arithmetic(mesh_2x2):
    m, k, b, c, s, nodes = 512, 8, 16, 3, 8, 64
    row = dryrun.run_udt_cell(mesh_2x2, m_examples=m, k_feats=k, n_bins=b,
                              n_classes=c, num_slots=s, max_nodes=nodes,
                              verbose=False)
    assert row["status"] == "OK", row.get("traceback")
    assert row["shape"] == f"m{m}_k{k}" and row["chips"] == 4
    hist = row["collective_calls"]["reduce_scatter_tensor/hist"]
    assert hist == [1, s * (k // 2) * b * c * 4]
    assert row["collectives"]["reduce-scatter"] == hist[1]
    assert not any(key.startswith("all_reduce/hist")
                   for key in row["collective_calls"])
    # the fake recording against a real CPU run of the same step
    comm, axes = dryrun.production_comm(mesh_2x2)
    step = make_sharded_step(comm, DistConfig(data_axes=axes.data),
                             dryrun.udt_kw(b, nodes), s)
    g = torch.Generator().manual_seed(0)
    real = analysis.count(step, *dryrun.udt_inputs(
        m // 2, k // 2, b, c, s, nodes, "cpu", g), comm=comm)
    assert real["flops"] == row["flops"]
    assert real["bytes_accessed"] == row["bytes_accessed"]
    assert real["collectives"] == row["collectives"]
    assert dryrun.collective_calls(real["log"]) == row["collective_calls"]
