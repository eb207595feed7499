"""The frozen generators give the same data for the same seed."""
import numpy as np
import torch

from portbench.data.kdd99 import N_FEATURES, split_rows, synth_kdd99
from portbench.data.teacher import make_binned


def test_kdd99_deterministic_per_seed():
    a_cols, a_y = synth_kdd99(3000, 2**31 + 5)
    b_cols, b_y = synth_kdd99(3000, 2**31 + 5)
    c_cols, c_y = synth_kdd99(3000, 6)
    assert len(a_cols) == N_FEATURES
    assert np.array_equal(a_y, b_y) and not np.array_equal(a_y, c_y)
    for a, b in zip(a_cols, b_cols):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert set(a_cols[1]) <= {"tcp", "udp", "icmp"}


def test_split_is_seeded_and_disjoint():
    tr, va = split_rows(1000, 3, 0.1)
    assert len(va) == 100 and len(tr) == 900
    assert not set(tr) & set(va)
    assert np.array_equal(split_rows(1000, 3, 0.1)[1], va)


def test_teacher_deterministic_per_seed():
    cpu = torch.device("cpu")
    kw = dict(depth=4, base_logit=0.1, logit_scale=1.5, device=cpu)
    a = make_binned(5000, 6, 255, seed=2**31 + 9, **kw)
    b = make_binned(5000, 6, 255, seed=2**31 + 9, **kw)
    c = make_binned(5000, 6, 255, seed=10, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert int(a[0].min()) >= 0 and int(a[0].max()) <= 254
    assert 0.3 < float(a[1].mean()) < 0.8


def test_fit_tune_seeds_order_one_table():
    """Every seed carries the same rows, in its own order."""
    from portbench import harness, trace
    cell = harness.load_cell("kdd99_10pct_udt.fit_tune")
    cfg = harness.load_config(cell["config"])
    cfg["data"]["rows"] = 3000
    jobs = []
    for seed in (2**31 + 1, 2**31 + 2):
        job = harness.job_class("fit_tune")(config=cfg, cell=cell, seed=seed,
                                            device=torch.device("cpu"),
                                            spans=trace.Spans())
        job.draw()
        jobs.append(job)
    a, b = jobs
    assert not np.array_equal(a.y, b.y)
    assert np.array_equal(np.sort(a.y_tr), np.sort(b.y_tr))
    key = lambda j, idx: sorted(zip(j.y[idx], np.asarray(j.cols[5])[idx]))
    assert key(a, a.tr) == key(b, b.tr) and key(a, a.va) == key(b, b.va)
