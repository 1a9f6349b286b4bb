"""Wrapper of the paged decode-attention CUDA kernel
(``csrc/paged_attention.cu``).

:func:`paged_decode_attention_op` has the contract of the JAX package's
``repro.kernels.paged_attention.ops.paged_decode_attention_op`` (without
its ``impl``/``interpret`` switches: the device decides):

* a CUDA ``q`` launches the hand-written kernel or raises;
* a CPU ``q`` runs the plain version (:mod:`.ref`), and so does a
  ``meta`` one: it has no data for a kernel to read (the dry run); on a
  mesh each rank runs it over its lanes and KV heads;
* a ``DTensor`` ``q`` on the card launches the kernel over the local
  tensors when every operand is whole on the rank (a one-rank mesh) and
  raises otherwise (:func:`repro_torch.distributed.sharding.whole_on_rank`).

The pages may be any ``[num_pages, ps, KV, hd]`` view whose last dim is
contiguous -- the JAX layout, or one layer of the port's
``[num_pages + 1, L, ps, KV, hd]`` pools (``pool[:, layer]``), read in
place through its strides.

Passing ``k_self``/``v_self`` (and ``active``) selects the serving
decode's convention: the token's own K/V is not in the cache yet, so it is
read from them at position ``seq_len`` while the pages give ``pos <
seq_len``; inactive lanes give zeros.  This is not the JAX op called with
``seq_len - 1``: that would move the window by one.

On the card the op splits each lane's context into chunks across blocks
and merges the chunks' partial softmax states in a second pass
(flash-decoding); :func:`plan_splits` picks the split from the shapes
alone, and :func:`.ref.paged_attention_split` is the plain version of
that arithmetic.

:data:`PAGED_KERNEL` counts op calls (one per call, whether the call
launches one pass or two).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from ...models.attention import FULL_WINDOW
from ...distributed.hints import current_hints
from ...distributed.sharding import (attention_axes, is_dtensor, shard_map,
                                     whole_on_rank)
from .._build import Kernel
from .ref import paged_attention_plain

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEADS_PER_BLOCK = 8   # MAXG of the kernel: query heads one block takes
MIN_CHUNK = 32            # positions a split takes at the least


def plan_splits(B: int, KV: int, G: int, P: int, ps: int, window: int,
                sm_count: int) -> tuple[int, int]:
    """``(n_splits, chunk)`` for one op call, from shapes alone.

    A lane's live positions number at most ``span = min(window, P * ps) +
    1`` (the cached window plus the self position); chunk ``s`` takes live
    indices ``[s * chunk, (s + 1) * chunk)``, so ``n_splits * chunk >=
    span`` covers every lane whatever its ``seq_len``.  The split fills
    one wave of blocks, ``sm_count // (B * KV * ceil(G / 8))`` splits,
    with chunks of at least ``MIN_CHUNK`` positions; one split when the
    unsplit grid already fills half the card or more (the merge pass
    costs more than a second wave saves: deepseek-7b's 128 blocks) or
    when the span fits one chunk.  ``seq_lens`` is never read: it lives
    on the device, and reading it would cost the decode step a host
    sync."""
    span = max(1, min(window, P * ps) + 1)
    blocks = B * KV * -(-G // MAX_HEADS_PER_BLOCK)
    want = max(1, sm_count // blocks)
    chunk = max(MIN_CHUNK, -(-span // want))
    return -(-span // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bind(lib: ctypes.CDLL) -> None:
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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
    if q.device.type in ("cpu", "meta"):
        if is_dtensor(q):
            return _plain_on_mesh(q, k_pages, v_pages, block_tables,
                                  seq_lens, window, k_self, v_self, active)
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     seq_lens, window, k_self, v_self, active)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_op: unsupported device "
                         f"{q.device}")
    if is_dtensor(q):
        return whole_on_rank(paged_decode_attention_op, q, q, k_pages,
                             v_pages, block_tables, seq_lens, window,
                             k_self=k_self, v_self=v_self, active=active)
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, int(window),
                   k_self, v_self, active)


def _plain_on_mesh(q, k_pages, v_pages, block_tables, seq_lens, window,
                   k_self, v_self, active) -> torch.Tensor:
    """The plain version on ``DTensor`` operands, on each rank over its
    lanes (the data axes, where they divide) and, under the ambient
    hints' ``gathered_kv`` spec (``kv_gather_shard="auto"``), its KV heads
    (``model``, where they divide; else, and under ``lanes``, every rank
    of a ``model`` group gathers and attends over all heads, as the
    reference's lanes-only gather does).  The pages are gathered whole
    over the data axes (the reference's pool-sized collective under the
    ``pages`` layout); the block tables and lane scalars split with the
    lanes."""
    mesh = q.device_mesh
    KV = k_pages.shape[2]
    dp, m = attention_axes(mesh, q.shape[0], KV)
    hints = current_hints()
    if hints.mesh is None or hints.gathered_kv_spec(KV)[2] is None:
        m = None
    heads, lanes = (dp, m, None), (dp,)
    pages = (None, None, m, None)
    specs = (heads, pages, pages, (dp, None), lanes, None,
             heads if k_self is not None else None,
             heads if v_self is not None else None,
             lanes if active is not None else None)
    return shard_map(paged_attention_plain, mesh, specs, heads)(
        q, k_pages, v_pages, block_tables, seq_lens, window, k_self, v_self,
        active)


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
    n_splits, chunk = plan_splits(B, KV, H // KV, P, ps, window,
                                  _sm_count(q.device))
    PAGED_KERNEL.build()
    out = torch.empty_like(q)
    part = None if n_splits == 1 else torch.empty(
        B * H * n_splits * (hd + 2), dtype=torch.float32, device=q.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = PAGED_KERNEL.lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), ptr(k_self),
        ptr(v_self), ptr(active), out.data_ptr(), ptr(part), B, H, KV, hd, ps,
        P, *k_pages.stride()[:3], window, chunk, n_splits, _DTYPE_CODE[dt],
        torch.cuda.current_stream(q.device).cuda_stream)
    PAGED_KERNEL.check(err, f"B={B} H={H} KV={KV} hd={hd} ps={ps} P={P} "
                            f"splits={n_splits}x{chunk}")
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
