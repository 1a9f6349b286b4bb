"""Public model API of the port (counterpart of
:mod:`repro.models.model_zoo`).

  init_params(cfg, seed, dtype, device)  -- DenseLM from a seeded generator
  params_from_numpy(tree, cfg, device)   -- DenseLM from the JAX package's
                                            parameter tree as numpy arrays
  make_paged_config(cfg, seq, lanes)     -- PagedKVConfig for a decode shape
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.lane_stash import autotune_stash
from ..core.paged_kv import PagedKVConfig
from ..device import DeviceLike, resolve_device
from .transformer import DenseLM, init_lm_params

DEFAULT_PAGE_SIZE = 64

_BLOCK_KEYS = {          # AttnBlock attribute -> path in the JAX layer tree
    "ln_attn": ("ln_attn",), "wq": ("attn", "wq"), "wk": ("attn", "wk"),
    "wv": ("attn", "wv"), "wo": ("attn", "wo"), "ln_mlp": ("ln_mlp",),
    "w_in": ("mlp", "w_in"), "w_out": ("mlp", "w_out"),
}


def init_params(cfg: ArchConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> DenseLM:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``.

    The draws differ from ``jax.random``'s for the same seed; parity with
    the JAX package goes through :func:`params_from_numpy`.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_lm_params(cfg, gen, dtype=dtype, device=dev)


def params_from_numpy(tree: Mapping, cfg: ArchConfig,
                      dtype: Optional[torch.dtype] = None,
                      device: DeviceLike = None) -> DenseLM:
    """The port's parameters from the JAX package's tree, already converted
    to numpy by the caller (``jax.tree.map(np.asarray, params)``).

    ``tree["layers"]`` is either the JAX package's stacked layout (every
    leaf ``[num_layers, ...]``) or a list of per-layer trees; it is
    unstacked into the module's blocks.  ``dtype`` defaults to the arrays'
    own.
    """
    dev = resolve_device(device)
    dt = dtype or torch.from_numpy(np.array(tree["embed"][:1])).dtype

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=dt)

    model = DenseLM(cfg, dt, dev)
    model.embed.data = tensor(tree["embed"])
    model.final_norm.data = tensor(tree["final_norm"])
    if not cfg.tie_embeddings:
        model.unembed.data = tensor(tree["unembed"])
    layers = tree["layers"]
    stacked = not isinstance(layers, (list, tuple))
    for i, block in enumerate(model.layers):
        for name, path in _BLOCK_KEYS.items():
            leaf = layers if stacked else layers[i]
            for key in path:
                leaf = leaf[key]
            getattr(block, name).data = tensor(leaf[i] if stacked else leaf)
    return model


def make_paged_config(
    cfg: ArchConfig,
    seq_len: int,
    lanes: int,
    page_size: int = DEFAULT_PAGE_SIZE,
    dtype: torch.dtype = torch.bfloat16,
    slack_pages: int = 8,
    stash_size: int | None = None,
    stash_watermark: int | None = None,
    stash_refill: int | None = None,
    scratch_slots: int | None = None,
) -> PagedKVConfig:
    """Size the page pool for ``lanes`` sequences of up to ``seq_len``
    tokens (the JAX package's sizing, full-attention case).

    Stash knobs left ``None`` are derived by :func:`autotune_stash`;
    ``scratch_slots=None`` means one workspace slot per lane.  The pool is
    rounded up to a multiple of 512 pages.
    """
    if cfg.attn_pattern != "full":
        raise NotImplementedError(
            "windowed attention patterns wait for a later slice "
            "(ROADMAP.md, Queue 1)")
    live_pages = math.ceil((seq_len + 1) / page_size)
    if stash_size is None or stash_watermark is None or stash_refill is None:
        pool0 = lanes * live_pages + slack_pages
        a_size, a_wm, a_rf = autotune_stash(page_size, None, lanes, pool0)
        size_derived = stash_size is None
        if size_derived:
            stash_size = a_size
        if stash_size == 0:
            if stash_watermark is None:
                stash_watermark = 2
            if stash_refill is None:
                stash_refill = 4
        else:
            if stash_watermark is None:
                stash_watermark = a_wm if size_derived else \
                    max(1, min(2, stash_size - 2))
            if stash_refill is None:
                stash_refill = a_rf if size_derived else \
                    min(4, stash_size - stash_watermark)
            if size_derived:
                stash_size = max(stash_size, stash_watermark + stash_refill)
    num_pages = lanes * (live_pages + stash_size) + slack_pages
    num_pages = -(-num_pages // 512) * 512
    return PagedKVConfig(
        num_kv_layers=max(cfg.num_attn_layers, 1),
        kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        page_size=page_size,
        num_pages=num_pages,
        max_lanes=lanes,
        max_pages_per_lane=live_pages,
        dtype=dtype,
        stash_size=stash_size,
        stash_watermark=stash_watermark,
        stash_refill=stash_refill,
        scratch_slots=lanes if scratch_slots is None else scratch_slots,
    )
