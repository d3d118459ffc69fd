"""Argument checks the kernel wrappers share: the device of a call, the
shapes, types and layout a kernel takes, and 16-byte aligned operands."""

from __future__ import annotations

import torch


def _device_of(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def _check(dev, named_shapes: dict, bf16=frozenset()):
    """Raise on anything the kernels do not take (``None`` entries skip).
    The tensors named in ``bf16`` must be bfloat16, the others float32."""
    for name, (t, shape) in named_shapes.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        dtype = torch.bfloat16 if name in bf16 else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {str(dtype)[6:]}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _aligned(t):
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernels stage their operands in 16-byte chunks); None stays None."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()
