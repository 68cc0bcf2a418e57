"""Clock stamps in stream order (``csrc/stamp.cu``): the device's
``%globaltimer`` on the card, the host clock on the CPU.

Replaces no TPU kernel: it times phases inside a captured program, where a
host clock sees only the replay's launch (see ``csrc/stamp.cu``).
"""

from __future__ import annotations

import ctypes
import time

import torch

from . import _build


def _lib():
    lib = _build.load("stamp")
    if lib.stamp.argtypes is None:
        lib.stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.stamp.restype = ctypes.c_int
    return lib


def stamp(slots: torch.Tensor, index: int) -> None:
    """Write the clock (ns) into ``slots[index]`` of an int64 tensor: on
    the card a one-thread kernel on the current stream, so the value is
    the time the stream reached it; on the CPU ``time.time_ns()``."""
    if slots.dtype != torch.int64 or slots.dim() != 1 \
            or not 0 <= index < slots.shape[0]:
        raise ValueError(f"need an int64 vector with slot {index}, got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    if slots.device.type == "cpu":
        slots[index] = time.time_ns()
        return
    if slots.device.type != "cuda" or not slots.is_contiguous():
        raise ValueError(f"unsupported slots on {slots.device}")
    _build.check(_lib().stamp(ctypes.c_void_p(slots[index:].data_ptr()),
                              _build.stream_ptr(slots.device)), "stamp")
