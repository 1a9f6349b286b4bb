"""Public model API of the port (counterpart of
:mod:`repro.models.model_zoo`).

  init_params(cfg, seed, dtype, device)  -- the family's LM (DenseLM,
                                            HybridLM, RWKV6LM or WhisperLM)
                                            from a seeded generator
  params_from_numpy(tree, cfg, device)   -- the same from the JAX package's
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
from .layers import LayerNorm
from .mamba2 import F32_PARAMS
from .rwkv6 import F32_PARAMS as RWKV6_F32_PARAMS
from .transformer import init_lm_params, lm_class

DEFAULT_PAGE_SIZE = 64

_BLOCK_KEYS = {          # AttnBlock attribute -> path in the JAX layer tree
    "ln_attn": ("ln_attn",), "wq": ("attn", "wq"), "wk": ("attn", "wk"),
    "wv": ("attn", "wv"), "wo": ("attn", "wo"), "ln_mlp": ("ln_mlp",),
    "w_in": ("mlp", "w_in"), "w_out": ("mlp", "w_out"),
}
_BIAS_KEYS = {"bq": ("attn", "bq"), "bk": ("attn", "bk"),   # qkv_bias only
              "bv": ("attn", "bv")}
_MLP_BIAS_KEYS = {"b_in": ("mlp", "b_in"),                  # gelu MLP only
                  "b_out": ("mlp", "b_out")}
_MAMBA_KEYS = ("in_proj", "out_proj", "conv_w", "conv_b", "A_log", "D",
               "dt_bias", "norm_scale")
_CROSS_KEYS = {"ln": ("ln",), "wq": ("attn", "wq"), "wk": ("attn", "wk"),
               "wv": ("attn", "wv"), "wo": ("attn", "wo")}
_RWKV6_KEYS = {          # RWKV6Layer sub-module -> its JAX leaves
    "tm": ("mix", "wr", "wk", "wv", "wg", "wo", "decay_lora_a",
           "decay_lora_b", "decay_base", "bonus_u", "ln_out"),
    "cm": ("mix", "wk", "wv", "wr"),
}


def init_params(cfg: ArchConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None):
    """Random weights from ``torch.Generator(device).manual_seed(seed)``.

    The draws differ from ``jax.random``'s for the same seed; parity with
    the JAX package goes through :func:`params_from_numpy`.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_lm_params(cfg, gen, dtype=dtype, device=dev)


def params_from_numpy(tree: Mapping, cfg: ArchConfig,
                      dtype: Optional[torch.dtype] = None,
                      device: DeviceLike = None):
    """The port's parameters from the JAX package's tree, already converted
    to numpy by the caller (``jax.tree.map(np.asarray, params)``).

    ``tree["layers"]`` (and whisper's ``enc_layers``/``cross_layers``) is
    either the JAX package's stacked layout (every leaf ``[num_layers,
    ...]``) or a list of per-layer trees; it is unstacked into the
    module's layers.  With ``cfg.qkv_bias`` each block also carries
    ``attn.bq/bk/bv``, with the plain GELU MLP ``mlp.b_in/b_out``; a
    LayerNorm is ``{scale, bias}``.  The hybrid tree's layers are ``{ln,
    mamba: {in_proj, ...}}`` beside one ``shared_attn`` block, rwkv6's
    ``{ln1, ln2, tm: {...}, cm: {...}}``.  ``dtype`` defaults to the
    arrays' own; the Mamba2 ``A_log``, ``D`` and ``dt_bias`` and RWKV6's
    ``decay_base`` and ``bonus_u`` stay f32, as in the JAX tree.
    """
    dev = resolve_device(device)
    dt = dtype or torch.from_numpy(np.array(tree["embed"][:1])).dtype

    def tensor(a, to=None) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=to or dt)

    def leaf(sub, path, i=None):
        for key in path:
            sub = sub[key]
        return sub if i is None else sub[i]

    def load(module, name, sub, path, i=None, to=None):
        """One parameter, or both of a LayerNorm's."""
        target = getattr(module, name)
        if isinstance(target, LayerNorm):
            for part in ("scale", "bias"):
                getattr(target, part).data = tensor(
                    leaf(sub, path + (part,), i))
        else:
            target.data = tensor(leaf(sub, path, i), to)

    def layer_trees(layers):
        stacked = not isinstance(layers, (list, tuple))
        return lambda i: (layers, i) if stacked else (layers[i], None)

    model = lm_class(cfg)(cfg, dt, dev)
    load(model, "embed", tree, ("embed",))
    load(model, "final_norm", tree, ("final_norm",))
    if not cfg.tie_embeddings:
        load(model, "unembed", tree, ("unembed",))

    keys = dict(_BLOCK_KEYS)
    if cfg.qkv_bias:
        keys.update(_BIAS_KEYS)
    if cfg.act == "gelu":
        keys.update(_MLP_BIAS_KEYS)

    def load_blocks(blocks, layers, block_keys=keys):
        at = layer_trees(layers)
        for i, block in enumerate(blocks):
            sub, idx = at(i)
            for name, path in block_keys.items():
                load(block, name, sub, path, idx)

    at = layer_trees(tree["layers"])
    if cfg.family == "hybrid":
        for i, layer in enumerate(model.layers):
            sub, idx = at(i)
            load(layer, "ln", sub, ("ln",), idx)
            for name in _MAMBA_KEYS:
                load(layer.mamba, name, sub, ("mamba", name), idx,
                     torch.float32 if name in F32_PARAMS else None)
        load_blocks([model.shared_attn], [tree["shared_attn"]])
    elif cfg.family == "ssm":
        for i, layer in enumerate(model.layers):
            sub, idx = at(i)
            for name in ("ln1", "ln2"):
                load(layer, name, sub, (name,), idx)
            for part, names in _RWKV6_KEYS.items():
                for name in names:
                    load(getattr(layer, part), name, sub, (part, name), idx,
                         torch.float32 if name in RWKV6_F32_PARAMS else None)
    else:
        load_blocks(model.layers, tree["layers"])
    if cfg.family == "audio":
        load_blocks(model.enc_layers, tree["enc_layers"])
        load_blocks(model.cross_layers, tree["cross_layers"], _CROSS_KEYS)
        for name in ("enc_final_norm", "enc_pos", "dec_pos"):
            load(model, name, tree, (name,))
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
    tokens (the JAX package's sizing).  ``local_global`` sizes as full
    attention: its global layers keep every page live, so no page is
    recycled and the stash is tuned without a window.

    Stash knobs left ``None`` are derived by :func:`autotune_stash`;
    ``scratch_slots=None`` means one workspace slot per lane.  The pool is
    rounded up to a multiple of 512 pages.  The hybrid family holds one KV
    layer per shared-block application (``num_layers // attn_every``) and
    one recurrent-state slot per lane (``state_slots``, a tenant between
    the KV pages and the scratch); the ssm family has the state slots too
    and one KV layer that no step writes, as in the JAX package.
    """
    if cfg.attn_pattern not in ("full", "local_global"):
        raise NotImplementedError(
            "sliding-window page recycling waits for a later slice "
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
        state_slots=lanes if cfg.family in ("ssm", "hybrid") else 0,
        stash_size=stash_size,
        stash_watermark=stash_watermark,
        stash_refill=stash_refill,
        scratch_slots=lanes if scratch_slots is None else scratch_slots,
    )
