"""End-to-end training launcher of the port (counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1

Runs a training loop on synthetic LM data with checkpoint / restart: kill
it at any step and rerun the same command, and it resumes from the latest
checkpoint (the reference's layout: either package can resume the other's
run).  Under an existing process group the run is the sharded LM on a
mesh: ``--mesh local`` (the default) takes ``make_smoke_mesh``'s
(1, world) ("data", "model") mesh, ``--mesh prod`` the production mesh,
which needs 256 ranks.  Each rank holds its blocks of the state and its
data block of each batch; rank 0 writes the whole state's checkpoints,
which resume on a mesh or on one card.  ``--arch udt`` trains the paper's decision tree instead
(the shared launcher).  Everything runs on the card; ``--device cpu`` runs
it on the CPU (``--smoke`` gives the reduced configs that fit there).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.checkpoint import (latest_step, restore_train_state,
                                    save_train_state)
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh, mesh_axes
from repro_torch.models.placement import shard_train_state
from repro_torch.models.sharding import set_activation_axes, shard_batch
from repro_torch.train import init_train_state, make_train_step

__all__ = ["synthetic_lm_batch", "train_udt", "train_lm", "build_parser",
           "main"]


def _frontend_draw(shape, step, seed, device):
    """Standard normals for the audio frames / vision patches of ``step``.
    The reference draws them with ``jax.random.normal(jax.random.key(step),
    ...)``; a torch generator cannot draw threefry bits, so the port draws
    from ``torch.Generator(device).manual_seed(seed + step)``.  This is the
    seam where the parity tests feed the reference's arrays in."""
    g = torch.Generator(device=device).manual_seed(seed + step)
    return torch.randn(shape, generator=g, device=device)


def synthetic_lm_batch(cfg, batch, seq, step, *, seed=17, device=None):
    """Deterministic synthetic token stream (markov-ish so the loss can
    drop), keyed by step so a resumed run continues the same stream.  The
    tokens and labels are the reference's numpy draws exactly; tensors on
    ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed + step)
    v = min(cfg.vocab, 4096)
    base = rng.integers(0, v, size=(batch, seq + 1), dtype=np.int64)
    # inject learnable structure: token_{t+1} = (token_t * 31 + 7) % v on 60%
    copy = rng.uniform(size=(batch, seq)) < 0.6
    nxt = (base[:, :-1] * 31 + 7) % v
    base[:, 1:][copy] = nxt[copy]
    ints = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    out = {"tokens": ints(base[:, :-1]), "labels": ints(base[:, 1:])}
    if cfg.frontend == "audio_frames":
        out = {"frames": _frontend_draw((batch, seq, cfg.frontend_dim), step,
                                        seed, dev),
               "labels": out["labels"] % cfg.vocab}
    elif cfg.frontend == "vision_patches":
        out["patches"] = _frontend_draw(
            (batch, cfg.n_prefix, cfg.frontend_dim), step, seed, dev)
    return out


def train_udt(args, device=None) -> dict:
    """``--arch udt``: bin ``--dataset``, build the paper's tree (level
    checkpoints into ``--ckpt-dir`` when given), tune it without
    retraining and score the test split.  The config keeps its default
    backends, as the reference's launcher does.  Prints three lines;
    returns the tree, the tuning result and the test accuracy."""
    from repro_torch.checkpoint import TreeCheckpointer
    from repro_torch.core import build_tree, fit_bins, predict_bins, transform, tune
    from repro_torch.data import make_dataset, train_val_test_split
    dev = resolve_device(device)
    cols, y, c = make_dataset(args.dataset, scale=args.scale)
    (tr_c, tr_y), (va_c, va_y), (te_c, te_y) = train_val_test_split(cols, y)
    table = fit_bins(tr_c, max_num_bins=args.bins)
    cfg = (configs.get_smoke("udt_paper") if args.smoke
           else configs.get("udt_paper"))
    t0 = time.time()
    cb = TreeCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    tree = build_tree(table, tr_y, cfg, n_classes=c, level_callback=cb,
                      device=dev)
    print(f"train: {tree.n_nodes} nodes depth {tree.max_tree_depth} "
          f"in {time.time()-t0:.2f}s")
    t0 = time.time()
    res = tune(tree, transform(va_c, table), va_y, table.n_num,
               train_size=len(tr_y), classification=c is not None,
               device=dev)
    print(f"tune: {res.n_configs} configs in {time.time()-t0:.3f}s "
          f"-> dmax={res.best_dmax} smin={res.best_smin}")
    pred = predict_bins(tree, transform(te_c, table), table.n_num,
                        max_depth=res.best_dmax,
                        min_samples_split=res.best_smin, device=dev)
    acc = float((pred.cpu().numpy() == te_y).mean())
    print(f"test acc: {acc:.4f}")
    return dict(tree=tree, tune=res, test_acc=acc)


def train_lm(args, device=None) -> dict:
    """The LM loop: the config, ``init_train_state`` from a generator
    seeded 0, resume from the latest checkpoint of ``--ckpt-dir`` (its
    ``data_offset`` is the next step), ``--steps`` steps on
    ``synthetic_lm_batch``, a checkpoint every ``--ckpt-every`` steps and
    of the last step.  The only host reads are the print lines (every 10
    steps and the last) and the checkpoints.  Returns the state, the first
    step run, each step's metrics (device tensors) and the loop's
    seconds."""
    dev = resolve_device(device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    mesh = (make_production_mesh() if args.mesh == "prod"
            else make_smoke_mesh())
    set_activation_axes(mesh_axes(mesh), mesh)

    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    if mesh is not None:                 # the rank's blocks of the state
        state = shard_train_state(state)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, manifest = restore_train_state(state, args.ckpt_dir)
        start = manifest["extra"]["data_offset"]
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, lr=args.lr, microbatch=args.microbatch)
    metrics = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = shard_batch(synthetic_lm_batch(cfg, args.batch, args.seq,
                                               step, device=dev))
        state, m = step_fn(state, batch)
        metrics.append(m)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_train_state(state, args.ckpt_dir, step + 1,
                             data_offset=step + 1)
    # the last step, unless the loop has just written it (the reference
    # writes it a second time, the same bytes)
    if args.ckpt_dir and latest_step(args.ckpt_dir) != args.steps:
        save_train_state(state, args.ckpt_dir, args.steps,
                         data_offset=args.steps)
    print("done")
    return dict(state=state, start=start, metrics=metrics,
                seconds=time.time() - t0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="local", choices=["local", "prod"])
    # udt options
    ap.add_argument("--dataset", default="churn_modeling")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--bins", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.arch == "udt":
        train_udt(args, args.device)
    else:
        train_lm(args, args.device)


if __name__ == "__main__":
    main()
