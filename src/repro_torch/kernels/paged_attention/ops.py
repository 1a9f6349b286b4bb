"""Wrapper of the paged decode-attention CUDA kernel
(``csrc/paged_attention.cu``).

:func:`paged_decode_attention_op` has the contract of the JAX package's
``repro.kernels.paged_attention.ops.paged_decode_attention_op`` (without
its ``impl``/``interpret`` switches: the device decides):

* a CUDA ``q`` launches the hand-written kernel or raises;
* a CPU ``q`` runs the plain version (:mod:`.ref`).

The pages may be any ``[num_pages, ps, KV, hd]`` view whose last dim is
contiguous -- the JAX layout, or one layer of the port's
``[num_pages + 1, L, ps, KV, hd]`` pools (``pool[:, layer]``), read in
place through its strides.

Passing ``k_self``/``v_self`` (and ``active``) selects the serving
decode's convention: the token's own K/V is not in the cache yet, so it is
read from them at position ``seq_len`` while the pages give ``pos <
seq_len``; inactive lanes give zeros.  This is not the JAX op called with
``seq_len - 1``: that would move the window by one.

:data:`PAGED_KERNEL` counts launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ...models.attention import FULL_WINDOW
from .._build import Kernel
from .ref import paged_attention_plain

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int


PAGED_KERNEL = Kernel(
    "paged_attention",
    Path(__file__).resolve().parent / "csrc" / "paged_attention.cu", _bind)


def paged_decode_attention_op(
    q: torch.Tensor,             # [B, H, hd]
    k_pages: torch.Tensor,       # [num_pages, ps, KV, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32, NO_BLOCK for empty slots
    seq_lens: torch.Tensor,      # [B] int32
    window: int = FULL_WINDOW,
    *,
    k_self: Optional[torch.Tensor] = None,   # [B, KV, hd]
    v_self: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,   # [B] bool (self mode)
) -> torch.Tensor:
    """Returns ``[B, H, hd]`` in q's dtype."""
    self_mode = k_self is not None
    if self_mode != (v_self is not None):
        raise ValueError("pass both k_self and v_self, or neither")
    if active is not None and not self_mode:
        raise ValueError("active lanes apply to the self mode only")
    if self_mode and active is None:
        active = torch.ones(q.shape[:1], dtype=torch.bool, device=q.device)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     seq_lens, window, k_self, v_self, active)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_op: unsupported device "
                         f"{q.device}")
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, int(window),
                   k_self, v_self, active)


def _launch(q, k_pages, v_pages, block_tables, seq_lens, window, k_self,
            v_self, active) -> torch.Tensor:
    B, H, hd = q.shape
    n_pages, ps, KV, _ = k_pages.shape
    P = block_tables.shape[1]
    dt = q.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, "
                        f"got {dt}")
    if hd not in HEAD_DIMS or H % KV:
        raise ValueError(f"need hd in {HEAD_DIMS} and KV | H, got hd={hd} "
                         f"H={H} KV={KV}")
    if not -2**31 <= window < 2**31:
        raise ValueError(f"window {window} does not fit int32")
    vec = 16 // q.element_size()
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} on {q.device}")
        if tuple(t.shape) != (n_pages, ps, KV, hd) \
                or t.stride() != k_pages.stride():
            raise ValueError(f"{name} must match k_pages' shape and strides")
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned "
                             f"last dim and strides in whole 16-byte units")
    _check(q, "q", (B, H, hd), dt, q.device)
    _check(block_tables, "block_tables", (B, P), torch.int32, q.device)
    _check(seq_lens, "seq_lens", (B,), torch.int32, q.device)
    if k_self is not None:
        for name, t in (("k_self", k_self), ("v_self", v_self)):
            _check(t, name, (B, KV, hd), dt, q.device)
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        _check(active, "active", (B,), torch.bool, q.device)
    PAGED_KERNEL.build()
    out = torch.empty_like(q)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = PAGED_KERNEL.lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), ptr(k_self),
        ptr(v_self), ptr(active), out.data_ptr(), B, H, KV, hd, ps, P,
        *k_pages.stride()[:3], window, _DTYPE_CODE[dt],
        torch.cuda.current_stream(q.device).cuda_stream)
    PAGED_KERNEL.check(err, f"B={B} H={H} KV={KV} hd={hd} ps={ps} P={P}")
    PAGED_KERNEL.launches += 1
    return out


def _check(t: torch.Tensor, name: str, shape: tuple, dtype, device) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
