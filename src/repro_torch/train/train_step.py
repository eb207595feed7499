"""Training step (counterpart of ``repro.train.train_step``): CE loss (with
the vision prefix sliced off, an optional loss mask and a streamed CE over
sequence chunks), gradients from ``torch.autograd``, optional microbatch
accumulation, the bf16 gradient option, global-norm clipping and AdamW.

The step reads nothing back to the host: loss and grad norm come back as
device tensors.

Under a mesh the state is the rank's sharded one
(``models.placement.shard_train_state``) and the batch its data block
(``sharding.shard_batch``).  The loss is the global masked mean: the
psum over the data axes of ``(nll * mask).sum()`` over that of
``mask.sum()`` (tag ``"loss"``).  The streamed CE runs on the vocab
block of the table: a distributed log-softmax (a pmax and one psum over
``model``, tag ``"ce"``), never a ``[tokens, vocab]`` gather.  The
gradients are cast to ``grad_dtype`` before the data-parallel reduce: one
psum over the data axes of every gradient that the data axes do not
split, bucketed (tag ``"grad"``); FSDP-split ones were psum-scattered in
``grad_dtype`` by the backward (tag ``"fsdp_grad"``).  The global norm
sums each block's squares over the axes that split it and counts a
replicated block once; AdamW runs on the blocks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         clip_by_global_norm)

__all__ = ["TrainState", "init_train_state", "loss_fn", "loss_and_grads",
           "make_train_step", "opt_dtype", "reduce_data_parallel"]


class TrainState(NamedTuple):
    model: M.LM          # the parameters, updated in place by the step
    opt: dict            # adamw_init's {"m", "v", "step"}


def opt_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.opt_dtype == "bfloat16" else torch.float32


def init_train_state(cfg: ModelConfig, generator: torch.Generator | None = None,
                     device=None) -> TrainState:
    """``models.model.init_params`` on ``device`` (``None`` means CUDA) and
    zero AdamW moments in ``cfg.opt_dtype``."""
    model = M.init_params(cfg, generator, resolve_device(device))
    return TrainState(model, adamw_init(dict(model.named_parameters()),
                                        opt_dtype(cfg)))


# elements a bucket of the data-parallel gradient psum holds at most
GRAD_BUCKET = 1 << 26


def _nll(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def _nll_split(logits, labels, vocab):
    """The NLL of ``labels`` from logits whose vocab may be split over
    ``model`` (this rank holds columns ``[lo, lo + V_loc)``): the max by a
    pmax, the sum of exponentials and the label's shifted logit by one
    psum over ``model`` (tag ``"ce"``).  Under no mesh the same arithmetic
    with no collective."""
    z = logits.float()
    m = z.max(dim=-1, keepdim=True).values.detach()
    split = SH.model_split(vocab)
    if split:
        m = SH.COMM.pmax(m, (SH.ACT_AXES.model,), "ce")
    zs = z - m
    se = zs.exp().sum(dim=-1)
    local = labels.long() - (SH.model_index() * z.shape[-1] if split else 0)
    inside = (local >= 0) & (local < z.shape[-1])
    zy = torch.gather(zs, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    zy = torch.where(inside, zy, 0.0)
    if split:
        se, zy = SH.from_model_parallel(torch.stack([se, zy]), "ce")
    return torch.log(se) - zy


def _chunk_nll(h, y, table, softcap, vocab):
    logits = torch.einsum("btd,vd->btv", h, table)
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return _nll_split(logits, y, vocab)


def loss_fn(model: M.LM, batch: dict, *, loss_chunk: int = 0):
    """CE loss.  loss_chunk > 0 streams the unembed + softmax over ``nc``
    sequence chunks (the largest divisor of T not above T // loss_chunk,
    at least 1), each under ``torch.utils.checkpoint``: its f32
    [B, T / nc, vocab] logits are dropped after the forward and recomputed
    in the backward, so the [tokens, vocab] buffer is never all live."""
    cfg = model.cfg
    labels = batch["labels"]
    t_lab = labels.shape[1]
    if not loss_chunk:
        logits = M.forward(model, batch).float()
        if cfg.frontend == "vision_patches":
            logits = logits[:, -t_lab:]
        nll = _nll(logits, labels)
    else:
        top = M._top_weights(model)
        hidden = M.forward(model, batch, return_hidden=True, _top=top)
        if cfg.frontend == "vision_patches":
            hidden = hidden[:, -t_lab:]
        if SH.model_split(cfg.vocab):     # each vocab block adds its share
            hidden = SH.to_model_parallel(hidden, tag="ce")
        table = (top["head"].T if not cfg.causal
                 else top["embed"]).to(hidden.dtype)
        t = hidden.shape[1]
        nc = max(1, t // loss_chunk)
        while t % nc:
            nc -= 1
        w = t // nc
        nll = torch.cat([checkpoint(
            _chunk_nll, hidden[:, c * w:(c + 1) * w],
            labels[:, c * w:(c + 1) * w], table, cfg.logit_softcap,
            cfg.vocab, use_reentrant=False, preserve_rng_state=False)
            for c in range(nc)], dim=1)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    num, den = (nll * mask).sum(), mask.sum()
    if SH.on_mesh():              # the global mean over the data axes
        num, den = SH.from_data_parallel(torch.stack([num, den.to(num.dtype)]),
                                         "loss")
    return num / torch.clamp_min(den, 1.0)


def loss_and_grads(model: M.LM, batch: dict, *, loss_chunk: int = 0,
                   grad_dtype: str = "float32"):
    """(loss, {parameter name: gradient}) of ``loss_fn`` by
    ``torch.autograd``; gradients cast to bf16 when ``grad_dtype`` says so."""
    names, params = zip(*model.named_parameters())
    gdt = torch.bfloat16 if grad_dtype == "bfloat16" else torch.float32
    with SH.fsdp_grad_dtype(gdt):
        loss = loss_fn(model, batch, loss_chunk=loss_chunk)
        # a parameter the loss does not reach (hubert's tied embedding: it
        # reads frames) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
    if grad_dtype == "bfloat16":
        grads = [g.to(torch.bfloat16) for g in grads]
    return loss.detach(), dict(zip(names, grads))


def reduce_data_parallel(grads: dict, specs: dict) -> dict:
    """The psum over the data axes of every gradient whose parameter the
    data axes do not split, flattened into buckets of at most
    ``GRAD_BUCKET`` elements per dtype (tag ``"grad"``): a few
    collectives, never one a tensor."""
    data = set(SH.ACT_AXES.data)
    names = [n for n in grads if not data & set(SH.spec_axes(specs[n]))]
    out = dict(grads)
    buckets, cur, size = [], [], 0
    for n in names:
        if cur and (size + grads[n].numel() > GRAD_BUCKET
                    or grads[n].dtype != grads[cur[0]].dtype):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(n)
        size += grads[n].numel()
    if cur:
        buckets.append(cur)
    axes = tuple(SH.ACT_AXES.data)
    for bucket in buckets:
        flat = SH.COMM.psum(torch.cat([grads[n].reshape(-1) for n in bucket]),
                            axes, "grad")
        o = 0
        for n in bucket:
            k = grads[n].numel()
            out[n] = flat[o:o + k].view(grads[n].shape)
            o += k
    return out


def make_train_step(cfg: ModelConfig, *, lr=3e-4, max_grad_norm=1.0,
                    microbatch: int = 0, grad_dtype: str | None = None,
                    loss_chunk: int | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the step
    writes the new parameters and moments into ``state`` in place, and
    ``metrics`` holds ``loss`` and ``grad_norm`` as device tensors.

    microbatch > 1: the batch is split into that many microbatches along
    axis 0; their gradients are summed in ``grad_dtype``, in order, then
    divided by ``microbatch``, and so is the loss.
    grad_dtype: ``None`` means bf16 when ``cfg.opt_dtype`` is bf16, else
    f32.  The gradients are cast before the data-parallel reduce (under a
    mesh), so the bf16 cast halves its bytes, as in the reference.
    loss_chunk: positions per streamed-CE chunk; ``None`` = auto (512 when
    vocab >= 32,768), 0 = off.
    """
    if loss_chunk is None:
        loss_chunk = 512 if cfg.vocab >= 32_768 else 0
    if grad_dtype is None:
        grad_dtype = "bfloat16" if cfg.opt_dtype == "bfloat16" else "float32"
    kw = dict(loss_chunk=loss_chunk, grad_dtype=grad_dtype)

    def train_step(state: TrainState, batch: dict):
        if microbatch and microbatch > 1:
            gdt = (torch.bfloat16 if grad_dtype == "bfloat16"
                   else torch.float32)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.model.device)
            grads = {n: torch.zeros(p.shape, dtype=gdt, device=p.device)
                     for n, p in state.model.named_parameters()}
            micro = {k: v.reshape(microbatch, v.shape[0] // microbatch,
                                  *v.shape[1:]) for k, v in batch.items()}
            for i in range(microbatch):
                mb_loss, g = loss_and_grads(
                    state.model, {k: v[i] for k, v in micro.items()}, **kw)
                loss = loss + mb_loss
                grads = {n: grads[n] + g[n] for n in grads}
            loss = loss / microbatch
            grads = {n: g / microbatch for n, g in grads.items()}
        else:
            loss, grads = loss_and_grads(state.model, batch, **kw)
        specs = state.model.specs if SH.on_mesh() else None
        if specs is not None:
            grads = reduce_data_parallel(grads, specs)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, specs)
        adamw_update(grads, state.opt, dict(state.model.named_parameters()),
                     lr=lr)
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step
