"""Batched serving driver of the port (counterpart of ``repro.launch.serve``).

LM mode:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --batch 4 --prompt-len 16 --gen 32

Initialises a model on the card from a seeded generator, prefills a batch
of seeded prompts, then decodes with the single-token serve step.

Forest mode (the tree reproduction's serving path, docs/serving.md):

    PYTHONPATH=src python -m repro_torch.launch.serve --forest \
        --tenants 3 --requests 50

Trains ``--tenants`` tiny synthetic ensembles, registers them in one
ModelRegistry, and drives a mixed request stream through the bucketed
ForestServer, printing per-request latency, the number of serve
executables (one CUDA graph per bucket on the card) and the
packed-vs-f32 byte accounting.

Both modes run on the card; ``--device cpu`` runs them on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh, mesh_axes
from repro_torch.models import model as M
from repro_torch.models.sharding import set_activation_axes
from repro_torch.serve import generate

__all__ = ["build_parser", "serve_lm", "serve_forest", "main"]


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_forest(args, device=None) -> dict:
    """--forest mode: multi-tenant bucketed tree serving on synthetic data.
    Prints three lines; returns the per-request latencies (s), the serve
    executables built and the request cost."""
    from repro_torch.core import (GradientBoostedTrees, TreeConfig, fit_bins,
                                  transform)
    from repro_torch.data import make_regression, train_val_test_split
    from repro_torch.serve import BatchPolicy, ForestServer, ModelRegistry

    dev = resolve_device(device)
    registry = ModelRegistry(capacity=max(4, args.tenants), device=dev)
    val = []
    for i in range(args.tenants):
        cols, y = make_regression(2_000, 6, seed=i)
        (tr_c, tr_y), (va_c, _), _ = train_val_test_split(cols, y, seed=i)
        table = fit_bins(tr_c, max_num_bins=32)
        gbt = GradientBoostedTrees(
            n_trees=8, loss="squared", seed=i,
            config=TreeConfig(max_depth=4, task="regression_variance"))
        gbt.fit(table, tr_y.astype(np.float32), device=dev)
        registry.add(f"tenant{i}", gbt)
        val.append(transform(va_c, table))

    server = ForestServer(registry, BatchPolicy())
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    lat = []
    for r in range(args.requests):
        mid = r % args.tenants
        n = int(rng.integers(1, 65))
        rows = val[mid][rng.integers(0, val[mid].shape[0], size=n)]
        t1 = time.perf_counter()
        server.predict(mid, rows)
        lat.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0
    cost = registry.request_cost()
    print(f"{args.tenants} tenants, {args.requests} requests in {dt:.2f}s "
          f"({args.requests/dt:.1f} req/s incl. graph captures)")
    print(f"p50 {np.percentile(lat, 50)*1e3:.2f}ms "
          f"p99 {np.percentile(lat, 99)*1e3:.2f}ms, "
          f"{server.compile_count} serve executables over buckets "
          f"{sorted({b for b, _ in server._exec})}")
    print(f"packed {cost['node_bytes_packed']}B vs f32 "
          f"{cost['node_bytes_f32']}B node bytes/request "
          f"({cost['ratio']}x)")
    return dict(latency_s=lat, seconds=dt, executables=server.compile_count,
                cost=cost)


def serve_lm(args, device=None) -> dict:
    """LM mode: the config, ``init_params`` from a generator seeded 0, a
    prompt from a generator seeded 1, ``generate`` (temperature sampling
    from a generator seeded 2).  Returns the model, the prompt, the tokens
    (on the host: the one read back), the seconds of ``generate`` and of
    ``init_params``."""
    dev = resolve_device(device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    mesh = (make_production_mesh() if args.mesh == "prod"
            else make_smoke_mesh())
    set_activation_axes(mesh_axes(mesh), mesh)

    seeded = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    t0 = time.perf_counter()
    model = M.init_params(cfg, seeded(0), dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=seeded(1), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    out = generate(model, prompt, args.gen,
                   max_len=args.prompt_len + args.gen + 1,
                   temperature=args.temperature, generator=seeded(2),
                   device=dev).cpu()
    return dict(model=model, prompt=prompt, tokens=out,
                seconds=time.perf_counter() - t0, init_s=init_s)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mesh", default="local", choices=["local", "prod"])
    ap.add_argument("--forest", action="store_true",
                    help="serve tree ensembles instead of the LM stack")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.forest:
        serve_forest(args, args.device)
        return
    res = serve_lm(args, args.device)
    out, dt = res["tokens"], res["seconds"]
    toks = args.batch * args.gen
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s incl. prefill)")
    print(out[:, :16])


if __name__ == "__main__":
    main()
