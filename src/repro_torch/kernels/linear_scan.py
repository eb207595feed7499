"""The linear recurrence ``h_t = a_t * h_{t-1} + b_t`` (``h_{-1} = 0``)
over the time axis of ``[B, T, D]``, and its backward: the CUDA kernels'
wrappers, their plain PyTorch versions, and the op the LM's recurrent
blocks call (``models/rglru.py::_scan_linear_recurrence``: the RG-LRU and
the sLSTM).

The reference runs the recurrence with ``jax.lax.associative_scan``
(``repro.models.rglru._scan_linear_recurrence``, the sLSTM's scans in
``repro.models.xlstm.slstm_block``); no Pallas kernel.  The port runs it
in order over ``t``, which rounds as a per-position loop does (within the
reference's 1e-4 of XLA's tree).

``linear_scan(a, b)`` takes contiguous f32 ``[B, T, D]`` operands on one
CPU or CUDA device (checked once: by ``linear_scan`` off the card, by the
CUDA wrapper or the fake launch on it) and calls
``torch.ops.repro_torch.linear_scan``, a ``torch.library.custom_op``:

  * on a CUDA tensor, ``linear_scan_cuda`` launches ``csrc/linear_scan.cu``
    (one thread per (b, d) channel; the source says what bounds it);
  * on a CPU tensor, ``linear_scan_plain`` runs the per-position loop;
  * its fake implementation gives the output's shape;
  * its backward is ``torch.ops.repro_torch.linear_scan_backward`` (the same
    two routes: ``linear_scan_backward_cuda`` / ``_plain``), one reverse
    scan: ``lam_{T-1} = g_{T-1}``, ``lam_t = g_t + a_{t+1} * lam_{t+1}``,
    ``db_t = lam_t``, ``da_t = lam_t * h_{t-1}``.

So a dispatch mode (``launch/analysis.count``, the dry run) sees one op
forward and one backward, with exactly their operands' bytes, on fake,
CPU and card tensors alike.  Every product and sum is one rounding in the
order written, so the kernels equal the plain loops bit for bit, and the
backward equals autograd through the forward loop.  There is no fallback:
a CUDA tensor launches the kernel or raises.  The plain versions take any
float dtype (the op is gradchecked in float64 on the CPU); the kernels take
float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks
from repro_torch.kernels._checks import need, stream_of

__all__ = ["linear_scan", "linear_scan_cuda", "linear_scan_backward_cuda",
           "linear_scan_plain", "linear_scan_backward_plain"]


@torch.no_grad()
def linear_scan_plain(a, b):
    """The per-position loop: ``h_t = a_t * h_{t-1} + b_t``, a product then
    a sum, each rounded, a step."""
    h = torch.empty_like(b)
    if b.shape[1]:
        acc = torch.zeros_like(b[:, 0])
        for t in range(b.shape[1]):
            acc = a[:, t] * acc + b[:, t]
            h[:, t] = acc
    return h


@torch.no_grad()
def linear_scan_backward_plain(a, h, g):
    """(da, db) of ``linear_scan_plain`` from ``a``, its output ``h`` and the
    output's gradient ``g``: the reverse loop (module docstring)."""
    da, db = torch.empty_like(g), torch.empty_like(g)
    t_len = g.shape[1]
    for t in range(t_len - 1, -1, -1):
        lam = g[:, t] if t == t_len - 1 else g[:, t] + a[:, t + 1] * lam
        db[:, t] = lam
        da[:, t] = lam * (h[:, t - 1] if t else torch.zeros_like(lam))
    return da, db


def _operands(tensors, names):
    """Check contiguous f32 ``[B, T, D]`` operands of one shape on one CPU
    or CUDA device; their data pointers (0 for fake tensors)."""
    first = tensors[0]
    if not isinstance(first, torch.Tensor) or first.dim() != 3:
        raise ValueError(f"{names[0]}: expected a [B, T, D] tensor, got "
                         f"{getattr(first, 'shape', type(first).__name__)}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{names[0]}: on {first.device}; linear_scan runs "
                         "on the CPU or a CUDA device")
    return [need(t, n, torch.float32, tuple(first.shape), first.device)
            for t, n in zip(tensors, names)]


def linear_scan_cuda(a, b):
    """Launch the forward kernel on the current stream.
    ``linear_scan_cuda.launches`` counts its launches."""
    stream = stream_of(b.device)
    pa, pb = _operands((a, b), ("a", "b"))
    h = torch.empty_like(b)
    if h.numel():
        lib = _build.library()
        _build.check(lib.udt_linear_scan(pa, pb, h.data_ptr(), *b.shape,
                                         stream), "linear scan")
        linear_scan_cuda.launches += 1
        _checks.report("linear_scan", (), lambda: 0)
    return h


def linear_scan_backward_cuda(a, h, g):
    """Launch the backward kernel on the current stream: (da, db).
    ``linear_scan_backward_cuda.launches`` counts its launches."""
    stream = stream_of(g.device)
    pg, pa, ph = _operands((g, a, h), ("g", "a", "h"))
    da, db = torch.empty_like(g), torch.empty_like(g)
    if g.numel():
        lib = _build.library()
        _build.check(lib.udt_linear_scan_backward(
            pa, ph, pg, da.data_ptr(), db.data_ptr(), *g.shape, stream),
            "linear scan backward")
        linear_scan_backward_cuda.launches += 1
        _checks.report("linear_scan_backward", (), lambda: 0)
    return da, db


linear_scan_cuda.launches = 0
linear_scan_backward_cuda.launches = 0


@torch.library.custom_op("repro_torch::linear_scan", mutates_args=(),
                         device_types="cpu")
def _scan_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return linear_scan_plain(a, b)


@_scan_op.register_kernel("cuda")
def _(a, b):
    return linear_scan_cuda(a, b)


@_scan_op.register_fake
def _(a, b):
    if b.device.type == "cuda":        # the launch the card would make
        _operands((a, b), ("a", "b"))
        _checks.report("linear_scan", ())
    return torch.empty_like(b)


@torch.library.custom_op("repro_torch::linear_scan_backward",
                         mutates_args=(), device_types="cpu")
def _scan_backward_op(a: torch.Tensor, h: torch.Tensor,
                      g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return linear_scan_backward_plain(a, h, g)


@_scan_backward_op.register_kernel("cuda")
def _(a, h, g):
    return linear_scan_backward_cuda(a, h, g)


@_scan_backward_op.register_fake
def _(a, h, g):
    if g.device.type == "cuda":
        _operands((g, a, h), ("g", "a", "h"))
        _checks.report("linear_scan_backward", ())
    return torch.empty_like(g), torch.empty_like(g)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output)


def _backward(ctx, g):
    a, h = ctx.saved_tensors
    return _scan_backward_op(a, h, g.contiguous())


_scan_op.register_autograd(_backward, setup_context=_setup_context)


def linear_scan(a, b):
    """``h`` with ``h_t = a_t * h_{t-1} + b_t`` over axis 1, ``h_{-1} = 0``:
    one op forward and one backward (module docstring).  ``a`` and ``b``
    are contiguous f32 ``[B, T, D]`` on one device: checked here off the
    card, by ``linear_scan_cuda`` (or the fake launch) on it."""
    if b.device.type != "cuda":
        _operands((a, b), ("a", "b"))
    return _scan_op(a, b)
