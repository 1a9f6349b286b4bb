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
* a CPU ``q`` runs the plain version (:mod:`.ref`), and so does a
  ``meta`` one: it has no data for a kernel to read (the dry run); on a
  mesh each rank runs it over its lanes and KV heads
  (:func:`repro_torch.distributed.sharding.heads_local`);
* a ``DTensor`` ``q`` on the card launches the kernel over the local
  tensors when every operand is whole on the rank (a one-rank mesh) and
  raises otherwise (:func:`repro_torch.distributed.sharding.whole_on_rank`).

The kernel has no backward, so on either device the op raises when grad
mode is on and an input requires a gradient, rather than hand back a
result that would drop the attention's gradients; the training forward
takes ``mea_attention`` (``differentiable=True`` in
:mod:`repro_torch.models.transformer`).

:data:`FLASH_KERNEL` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ...models.attention import FULL_WINDOW
from ...distributed.sharding import heads_local, is_dtensor, whole_on_rank
from .._build import Kernel
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_op is forward-only: an input requires a "
            "gradient; train through mea_attention (differentiable=True)")
    if q.device.type in ("cpu", "meta"):
        return heads_local(functools.partial(
            flash_attention_ref, causal=causal, window=window,
            q_offset=q_offset), q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_op: unsupported device {q.device}")
    if is_dtensor(q):
        return whole_on_rank(flash_attention_op, q, q, k, v, causal=causal,
                             window=window, q_offset=q_offset)
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
