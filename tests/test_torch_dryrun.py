"""The dry run (``repro_torch.launch.dryrun``) against the reference's cells
and arithmetic, at smoke sizes.

* Every (arch, shape) cell's row: a SKIP row with the reference's reason
  (``repro.configs.cells()``) where it skips, else OK with the reference's
  row fields (one pattern group of the smoke config on a 2x2 recording
  mesh at a short length: the whole dry run is a full-width job of its
  own).
* The time-loop fit: the xLSTM's prefill and the RG-LRU model's train step
  fitted from three lengths equal a whole recording at a fourth, exactly,
  in FLOPs, bytes, every collective kind and the argument / output /
  alias bytes; the peak it reports is the longest length's, a lower
  bound.
* A decode step's collectives on a 2x2 recording mesh follow from the layer
  count and widths: one ``embed`` psum a step, one ``attn`` and one
  ``ffn`` psum a layer, one ``logits`` all-gather a step.
* The UDT cell at a reduced m and k on a 2x2 recording mesh: the histogram
  collective hands in the reference's per-chunk bytes (S x K_l x B x C x 4,
  the arithmetic phase ``dist`` holds against ``builder.chunks``), and the
  fake recording counts what a real CPU run of the step counts.
"""
import dataclasses
import fractions

import pytest
torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.core.distributed import DistConfig, make_sharded_step
from repro_torch.launch import analysis, dryrun

SMALL_SHAPES = {"train_4k": (16, 4, "train"),
                "prefill_32k": (16, 2, "prefill"),
                "decode_32k": (16, 4, "decode"),
                "long_500k": (32, 1, "decode")}
ROW_FIELDS = {"arch", "shape", "mesh", "chips", "status", "lower_compile_s",
              "flops", "bytes_accessed", "collectives", "memory",
              "compute_s", "memory_s", "collective_s", "bottleneck",
              "step_lower_bound_s", "model_flops_global",
              "hlo_flops_global", "model_vs_hlo", "fit_lengths"}


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
        row = dryrun.run_cell(arch, shape, mesh_2x2, correct=False,
                              verbose=False)
        assert row["status"] == "OK", row.get("traceback")
        assert ROW_FIELDS <= set(row), ROW_FIELDS - set(row)
        assert row["chips"] == 4 and row["fit_lengths"] is None
        assert row["flops"] > 0 and row["bytes_accessed"] > 0
        assert row["hlo_flops_global"] == 4 * row["flops"]
        assert row["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("arch,shape,unit", [
    ("xlstm_125m", "prefill_32k", 128), ("recurrentgemma_2b", "train_4k", 4)])
def test_time_loop_fit_is_exact(arch, shape, unit, mesh_2x2):
    """One layer of each kind of the smoke config: the fit is a sum over
    layers."""
    cfg = _one_group(arch)
    kind = configs.SHAPES[shape][2]
    comm, axes = dryrun.production_comm(mesh_2x2)
    assert dryrun.fit_unit(cfg, kind, axes) == unit

    def rec(n):
        return dryrun.record_cell(cfg, shape, *dryrun.production_comm(
            mesh_2x2), seq=n)

    lengths = [unit, 2 * unit, 3 * unit]
    fitted = {n: rec(n) for n in lengths}
    got = dryrun.fit(fitted, 4 * unit)
    whole = rec(4 * unit)
    assert got["flops"] == whole["flops"]
    assert got["bytes_accessed"] == whole["bytes_accessed"]
    assert got["collectives"] == whole["collectives"]
    assert whole["collectives"]["total"] > 0
    for k in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert got["memory"][k] == whole["memory"][k], k
    # the peak is no polynomial: the longest recorded length's, a lower
    # bound of the whole recording's
    assert got["memory"]["temp_bytes"] == fitted[3 * unit]["memory"][
        "temp_bytes"] <= whole["memory"]["temp_bytes"]


def test_fit_refuses_what_no_quadratic_fits():
    def pts(flops):
        return {n: {"flops": f, "bytes_accessed": n,
                    "memory": {"temp_bytes": 0},
                    "collectives": {"total": 0}}
                for n, f in zip((1, 2, 4), flops)}

    with pytest.raises(ValueError, match="not an integer"):
        dryrun.fit(pts((0, 0, 1)), 3)               # 1/3
    with pytest.raises(ValueError, match="not an integer"):
        dryrun.fit(pts((0, 1, 0)), 8)               # negative
    pts = {n: {"flops": 3 * n * n + 1, "bytes_accessed": 5 * n,
               "memory": {"temp_bytes": n, "argument_bytes": 7},
               "collectives": {"total": 2 * n}}
           for n in (2, 4, 6)}
    got = dryrun.fit(pts, 20)
    assert got == {"flops": 1201, "bytes_accessed": 100,
                   "collectives": {"total": 40},
                   "memory": {"temp_bytes": 6, "argument_bytes": 7}}
    assert dryrun._lagrange([1, 2, 3], [1, 4, 9],
                            fractions.Fraction(5, 2)) == fractions.Fraction(
                                25, 4)


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
