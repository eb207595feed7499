"""Argument checks shared by the CUDA kernel wrappers: the kernels take
contiguous tensors of one dtype on one CUDA device, and nothing else."""
from __future__ import annotations

import torch

__all__ = ["need", "stream_of"]


def need(t, name: str, dtype: torch.dtype, shape: tuple, device: torch.device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def stream_of(device: torch.device) -> int:
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    return torch.cuda.current_stream(device).cuda_stream
