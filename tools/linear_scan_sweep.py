"""Time the linear scan's staged kernels (``repro_torch/csrc/
linear_scan.cu``) on the card across launch plans, to see what bounds the
staged walk and to choose ``kernels/linear_scan.py::scan_plan``'s rule:

* ``tiles``: the plan's own launch at [B, 32768, D] for 80, 132, 160, 240
  and 320 tiles of 32 channels against the 132 SMs;
* ``plans``: every (steps a stage, stages) that fits the card's shared
  memory, at the LM's shapes (phase ``train``'s T = 128, a ``train_4k``
  batch, the 32k prefill at batch 1 and 2), the plan's pick marked.

    PYTHONPATH=src python3 tools/linear_scan_sweep.py

One JSON line a case: device ms a launch (torch.profiler's kernel spans,
``chip_smoke.device_ms``), and for the plan's own launches the bytes
bound at 3.35 TB/s and its share.  Every staged result is held bit for bit
against the short walk's (which the card tests and ``chip_smoke.py`` hold
against the plain loops).  Needs a card; imports torch and repro_torch
only."""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402

# [B, 32768, D]: 80, 132, 160, 240 and 320 tiles of 32 channels
TILE_SHAPES = ((1, 32768, 2560), (2, 32768, 2112), (2, 32768, 2560),
               (3, 32768, 2560), (4, 32768, 2560))
PLAN_SHAPES = ((8, 128, 2560), (8, 4096, 2560), (1, 32768, 2560),
               (2, 32768, 2560))
STEPS = (32, 64, 128, 256)
H100_OPTIN = 232448


def _operands(shape, dev):
    import torch
    from repro_torch.kernels.linear_scan import (linear_scan_backward_cuda,
                                                 linear_scan_cuda, scan_plan)
    a, b, gy, _ = C._scan_operands(shape, dev)
    walk = scan_plan(shape, short_t=shape[1] + 1)
    walk_b = scan_plan(shape, backward=True, short_t=shape[1] + 1)
    h = linear_scan_cuda(a, b, walk)
    da, db = linear_scan_backward_cuda(a, h, gy, walk_b)
    torch.cuda.synchronize()
    return a, b, gy, h, (da, db)


def _time(ops, plan, backward):
    """Device ms of one launch by ``plan``, checked against the walk."""
    import torch
    from repro_torch.kernels.linear_scan import (linear_scan_backward_cuda,
                                                 linear_scan_cuda)
    a, b, gy, h, grads = ops
    if backward:
        def fn():
            return linear_scan_backward_cuda(a, h, gy, plan)
        same = all(torch.equal(x, y) for x, y in zip(fn(), grads))
    else:
        def fn():
            return linear_scan_cuda(a, b, plan)
        same = torch.equal(fn(), h)
    C.need(same, f"staged != walk by {plan}")
    return C.device_ms(fn, (C._scan_kernels(plan, backward),))


def _plans(shape, backward):
    """Every staged plan of ``shape`` that fits a block's shared memory."""
    from repro_torch.kernels.linear_scan import (BARRIERS, MAX_STAGES,
                                                 RING_PAD, scan_plan)
    base = scan_plan(shape, backward=backward)
    for tc in STEPS:
        for stages in range(2, MAX_STAGES + 1):
            smem = stages * (3 if backward else 2) * tc * 32 * 4 + RING_PAD
            if smem + BARRIERS > H100_OPTIN or stages > -(-shape[1] // tc):
                continue
            yield dataclasses.replace(base, tc=tc, stages=stages, smem=smem)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("linear_scan_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.linear_scan import scan_plan
    dev = torch.device("cuda")
    print(C.smi_line(), flush=True)
    for shape in TILE_SHAPES:
        ops = _operands(shape, dev)
        n = shape[0] * shape[1] * shape[2]
        row = dict(shape=list(shape))
        for backward, nbytes in ((False, 12 * n), (True, 20 * n)):
            plan = scan_plan(shape, backward=backward)
            ms = _time(ops, plan, backward)
            bound = C.bound(nbytes, 0)[0]
            row["backward" if backward else "forward"] = dict(
                tiles=plan.grid, tc=plan.tc, stages=plan.stages,
                device_ms=ms, bound_ms=bound, share=bound / ms)
        print("tiles", json.dumps(row), flush=True)
        del ops
    for shape in PLAN_SHAPES:
        ops = _operands(shape, dev)
        for backward in (False, True):
            pick = scan_plan(shape, backward=backward)
            times = {f"{p.tc}x{p.stages}": _time(ops, p, backward)
                     for p in _plans(shape, backward)}
            best = min(times, key=times.get)
            print("plans", json.dumps(dict(
                shape=list(shape), direction="backward" if backward
                else "forward", pick=f"{pick.tc}x{pick.stages}",
                best=best, device_ms=times)), flush=True)
        del ops
    return 0


if __name__ == "__main__":
    sys.exit(main())
