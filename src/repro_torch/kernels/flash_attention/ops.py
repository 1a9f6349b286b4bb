"""Wrapper of the flash prefill-attention CUDA kernel
(``csrc/flash_attention.cu``).

:func:`flash_attention_op` has the contract of the JAX package's
``repro.kernels.flash_attention.ops.flash_attention_op``, forward only.
The JAX op's ``block_q``/``block_k`` are Pallas tiling knobs and its
``impl``/``interpret`` switches choose a TPU path; the port has none of
them: the kernel picks its own 64 x 64 tiles, masks a ragged tail, and the
device decides the path.  Unlike the Pallas kernel, which aligns query 0
with key 0, it takes a query offset (``q_offset``: a prefix-cache hit's
suffix attends over the cached prefix's keys):

* a CUDA ``q`` launches the hand-written kernel or raises;
* a CPU ``q`` runs the plain version (:mod:`.ref`).

:data:`FLASH_KERNEL` counts launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ...models.attention import FULL_WINDOW
from .._build import Kernel
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int


FLASH_KERNEL = Kernel(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu", _bind)


def flash_attention_op(
    q: torch.Tensor,    # [B, Tq, H, hd]
    k: torch.Tensor,    # [B, Tk, KV, hd]
    v: torch.Tensor,
    causal: bool = True,
    window: int = FULL_WINDOW,
    q_offset: int = 0,
) -> torch.Tensor:
    """Returns ``[B, Tq, H, hd]`` in q's dtype.  Query row i sits at
    absolute position ``q_offset + i`` and key j at ``j``: a prefill of a
    suffix over ``q_offset`` cached keys passes ``Tk = q_offset + Tq``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_op: unsupported device {q.device}")
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if hd not in HEAD_DIMS or H % KV:
        raise ValueError(f"need hd in {HEAD_DIMS} and KV | H, got hd={hd} "
                         f"H={H} KV={KV}")
    if not -2**31 <= window < 2**31:
        raise ValueError(f"window {window} does not fit int32")
    if not 0 <= q_offset < 2**30:
        raise ValueError(f"q_offset {q_offset} outside [0, 2**30)")
    for name, t, shape in (("q", q, (B, Tq, H, hd)), ("k", k, (B, Tk, KV, hd)),
                           ("v", v, (B, Tk, KV, hd))):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    FLASH_KERNEL.build()
    out = torch.empty_like(q)
    err = FLASH_KERNEL.lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq, Tk,
        H, KV, hd, int(causal), int(window), int(q_offset),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    FLASH_KERNEL.check(err, f"B={B} Tq={Tq} Tk={Tk} H={H} KV={KV} hd={hd} "
                            f"q_offset={q_offset}")
    FLASH_KERNEL.launches += 1
    return out
