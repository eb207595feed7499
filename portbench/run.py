"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (data from the seed, the program's own preparation, one warm-up
unit that builds every kernel), then units of work back to back for
``--seconds``, then the correctness check against the plain reference.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` profiles
a few more units and prints its per-layer metrics.  The last line of
standard output is the result as one JSON object; the compared numbers and
their limits are the last lines of standard error.  Exits non-zero, with
no result, without the CUDA devices the cell asks for, without the program
beside this folder, or with JAX loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _fixed_environment() -> None:
    """Every compile cache inside the checkout, at a fixed path; one host
    thread a library, so that runs on a shared host spread less."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = HERE / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_environment()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    bench = harness.load_benchmark()
    cell = harness.load_cell(args.workload)
    config = harness.load_config(cell["config"])
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not beside portbench/",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    code, lines = harness.execute(
        bench, args.workload, cell, config, seed=args.seed,
        seconds=args.seconds, trace_on=bool(args.trace),
        device=torch.device("cuda"), t_start=T_START)
    for line in lines["stderr"]:
        print(line, file=sys.stderr)
    if lines["stdout"]:
        print(lines["stdout"], flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
