"""Each cell run whole on the card, briefly: it prints a correct result
line naming the card (``pytest -m gpu portbench/tests``)."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import harness


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_benchmark()["workloads"]])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload", cell,
         "--seed", str(2**31 + 23), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
