"""Argument checks shared by the CUDA kernel wrappers: the kernels take
contiguous tensors of one dtype on one CUDA device, and nothing else.

Also the launch hook: ``listener`` (set by ``repro_torch.check``'s
recorder, None otherwise) hears of every launch a wrapper makes, and of
the launch it would make on fake tensors (``torch._subclasses``'
``FakeTensor``: shapes without data), where the wrapper returns empty
outputs of the right shapes and launches nothing."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["need", "stream_of", "is_fake", "report", "listener"]

# listener(kernel, modes, smem): one call per launch; ``smem`` is the
# launch's dynamic shared memory in bytes, None for a fake launch whose
# bytes only the card knows
listener = None


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def need(t, name: str, dtype: torch.dtype, shape: tuple, device: torch.device,
         row_stride=None):
    """Check ``t``; returns its data pointer (0 for a fake tensor).  With
    ``row_stride``, a 2-d ``t``'s rows need only be contiguous and that many
    elements apart."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if row_stride is None and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if row_stride is not None and ((shape[1] > 1 and t.stride(1) != 1) or (
            shape[0] > 1 and t.stride(0) != row_stride)):
        raise ValueError(f"{name}: rows must be contiguous and {row_stride} "
                         f"elements apart")
    return 0 if is_fake(t) else t.data_ptr()


def stream_of(device: torch.device) -> int:
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    return torch.cuda.current_stream(device).cuda_stream


def report(kernel: str, modes: tuple, smem=None) -> None:
    """Tell the listener, if any, of one launch of ``kernel``; ``smem`` is
    a callable giving its dynamic shared-memory bytes (None: a fake
    launch whose bytes only the card knows), called only when someone
    listens."""
    if listener is not None:
        listener(kernel, tuple(modes), None if smem is None else smem())
