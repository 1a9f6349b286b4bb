"""Public model API of the port (counterpart of
:mod:`repro.models.model_zoo`).

  init_params(cfg, seed, dtype, device)  -- the family's LM (DenseLM,
                                            HybridLM, RWKV6LM or WhisperLM)
                                            from a seeded generator
  abstract_params(cfg, dtype)            -- the same on the ``meta`` device
                                            (shapes and dtypes, no storage)
  params_from_numpy(tree, cfg, device)   -- the LM from the JAX package's
                                            parameter tree as numpy arrays
  params_to_numpy(params)                -- its inverse: the JAX tree
  jax_layout(named) / port_layout(tree, names)
                                         -- any per-parameter tensors (the
                                            weights, AdamW's m and v)
                                            between the two layouts
  forward_train(params, cfg, batch)      -- logits, on the training route
  loss_fn(params, cfg, batch)            -- (loss, metrics)
  input_specs(cfg, shape_name)           -- batch stand-ins on ``meta``
  synth_batch(cfg, batch, seq, seed)     -- a small real batch
  make_paged_config(cfg, seq, lanes)     -- PagedKVConfig for a decode shape
  splits_window(cfg)                     -- whether that cache splits
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..configs.base import SHAPES, ArchConfig
from ..core.lane_stash import autotune_stash
from ..core.paged_kv import PagedKVConfig
from ..device import DeviceLike, resolve_device
from .losses import softmax_cross_entropy
from .attention import FULL_WINDOW
from .transformer import (forward, init_lm_params, layer_windows, lm_class,
                          recycle_window)

IGNORE_LABEL = -1
DEFAULT_PAGE_SIZE = 64

#: module lists whose entries the JAX tree stacks along a leading layer axis
STACKED = ("layers", "enc_layers", "cross_layers")
#: an attention or cross block's attribute -> its group in the JAX tree
_BLOCK_GROUP = {name: "attn" for name in ("wq", "wk", "wv", "wo", "bq", "bk",
                                          "bv")}
_BLOCK_GROUP.update({name: "mlp" for name in ("w_in", "w_out", "b_in",
                                              "b_out")})


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


def abstract_params(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16):
    """The family's LM on the ``meta`` device: every parameter's shape and
    dtype, no storage (the JAX package's ``eval_shape`` tree)."""
    return lm_class(cfg)(cfg, dtype, torch.device("meta"))


def jax_path(name: str) -> tuple[tuple[str, ...], Optional[int]]:
    """A parameter's path in the JAX tree and its layer index (``None``
    outside the stacked lists): ``layers.3.wq`` -> ``(("layers", "attn",
    "wq"), 3)``, ``shared_attn.w_in`` -> ``(("shared_attn", "mlp",
    "w_in"), None)``, ``layers.0.tm.ln_out.bias`` -> ``(("layers", "tm",
    "ln_out", "bias"), 0)``."""
    parts = name.split(".")
    idx = None
    if parts[0] in STACKED:
        idx = int(parts[1])
        parts = parts[:1] + parts[2:]
    if len(parts) > 1 and parts[1] in _BLOCK_GROUP:
        parts.insert(1, _BLOCK_GROUP[parts[1]])
    return tuple(parts), idx


def jax_leaves(names) -> dict[tuple, list[str]]:
    """Parameter names grouped by the JAX leaf they make up: ``{path:
    [name]}``, a stacked leaf's names in layer order."""
    groups: dict[tuple, list] = {}
    for name in names:
        path, idx = jax_path(name)
        groups.setdefault(path, []).append((-1 if idx is None else idx, name))
    return {path: [n for _, n in sorted(items)]
            for path, items in groups.items()}


def jax_layout(named: Mapping[str, torch.Tensor]) -> dict:
    """Tensors named as the LM's parameters (``named_parameters()``, or
    AdamW's ``m``/``v``) -> the JAX package's nested tree, each stacked
    list's leaves ``torch.stack``-ed in layer order."""
    tree: dict = {}
    for path, names in jax_leaves(named).items():
        stacked = path[0] in STACKED
        _put(tree, path, torch.stack([named[n] for n in names]) if stacked
             else named[names[0]])
    return tree


def port_layout(tree: Mapping, names) -> dict[str, Any]:
    """The inverse of :func:`jax_layout`: ``{name: leaf}`` for each of the
    parameter ``names`` from the JAX tree (leaves of any array type).  A
    stacked list is either the stacked layout or a list of per-layer
    trees."""
    out = {}
    for name in names:
        path, idx = jax_path(name)
        sub = tree[path[0]]
        if idx is not None and isinstance(sub, (list, tuple)):
            sub, idx = sub[idx], None
        for key in path[1:]:
            sub = sub[key]
        out[name] = sub if idx is None else sub[idx]
    return out


def _put(tree: dict, path: tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


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
    model = lm_class(cfg)(cfg, dt, dev)
    named = dict(model.named_parameters())
    leaves = port_layout(tree, named)
    for name, p in named.items():
        p.data = torch.from_numpy(np.array(leaves[name])).to(device=dev,
                                                             dtype=p.dtype)
    return model


def params_to_numpy(params) -> dict:
    """The JAX package's parameter tree of ``params`` (the family's LM) in
    its stacked-layer layout, as numpy arrays on the host: the inverse of
    :func:`params_from_numpy`.  numpy has no bfloat16: a bf16 parameter
    comes back widened to f32 (exactly)."""
    tree = jax_layout({n: p.detach().cpu()
                       for n, p in params.named_parameters()})

    def to_numpy(sub):
        if isinstance(sub, dict):
            return {k: to_numpy(v) for k, v in sub.items()}
        return (sub.float() if sub.dtype == torch.bfloat16 else sub).numpy()
    return to_numpy(tree)


# --------------------------------------------------------------------------
# Training: forward, loss and inputs
# --------------------------------------------------------------------------

def forward_train(params, cfg: ArchConfig, batch: Mapping,
                  remat: bool = True, hints=None) -> torch.Tensor:
    """Logits ``[B, S, V]`` (S counts a vlm batch's patch rows) on the
    training route: every attention call site through ``mea_attention``
    (the flash kernel has no backward) and, with ``remat``, each layer
    under activation checkpointing.  ``hints``: :func:`forward`'s."""
    return forward(params, batch["tokens"],
                   prefix_embeds=batch.get("patches"),
                   encoder_frames=batch.get("frames"),
                   differentiable=True, remat=remat, hints=hints)


def loss_fn(params, cfg: ArchConfig, batch: Mapping, remat: bool = True,
            chunk_rows: Optional[int] = None, hints=None):
    """Next-token cross entropy; labels equal to ``IGNORE_LABEL`` are
    masked.  Returns ``(loss, {"loss", "tokens"})``, as the JAX
    ``loss_fn``; ``chunk_rows``: :func:`softmax_cross_entropy`'s.
    ``hints`` shard the logits' vocab over ``model`` on a mesh."""
    logits = forward_train(params, cfg, batch, remat=remat, hints=hints)
    if hints is not None:
        logits = hints.logits(logits)
    labels = batch["labels"]
    if cfg.family == "vlm":  # logits cover [prefix + tokens]; labels tokens
        logits = logits[:, -labels.shape[1]:]
    mask = labels != IGNORE_LABEL
    safe = torch.where(mask, labels, 0)
    nll = softmax_cross_entropy(logits, safe, chunk_rows)
    denom = mask.sum().clamp(min=1)
    loss = (nll * mask).sum() / denom
    return loss, {"loss": loss, "tokens": denom}


def input_specs(cfg: ArchConfig, shape_name: str,
                act_dtype: torch.dtype = torch.bfloat16
                ) -> dict[str, torch.Tensor]:
    """Batch inputs of a named shape (``configs.base.SHAPES``) as ``meta``
    tensors: shapes and dtypes, never allocated."""
    shp = SHAPES[shape_name]
    B, S = shp["global_batch"], shp["seq_len"]

    def spec(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    specs: dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        S -= cfg.frontend_tokens
        specs["patches"] = spec((B, cfg.frontend_tokens, cfg.d_model),
                                act_dtype)
    elif cfg.family == "audio":
        specs["frames"] = spec((B, cfg.encoder_seq_len, cfg.d_model),
                               act_dtype)
    specs["tokens"] = spec((B, S))
    if shp["kind"] == "train":
        specs["labels"] = spec((B, S))
    return specs


def synth_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                act_dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """A small real batch for smoke runs, laid out as the JAX function's
    (a vlm batch has ``min(frontend_tokens, seq // 2)`` patch rows ahead
    of its tokens; labels are the tokens rolled left by one), drawn from
    ``torch.Generator(seed)`` on the CPU: the values differ from
    ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    out: dict[str, torch.Tensor] = {}
    n_tok = seq
    if cfg.family == "vlm":
        P = min(cfg.frontend_tokens, max(seq // 2, 1))
        n_tok = seq - P
        out["patches"] = torch.randn((batch, P, cfg.d_model), generator=gen)
    elif cfg.family == "audio":
        out["frames"] = torch.randn((batch, cfg.encoder_seq_len,
                                     cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, n_tok), generator=gen,
                           dtype=torch.int32)
    out = {k: v.to(act_dtype) for k, v in out.items()}
    out["tokens"] = tokens
    out["labels"] = torch.roll(tokens, -1, dims=1)
    return {k: v.to(dev) for k, v in out.items()}


def splits_window(cfg: ArchConfig) -> bool:
    """Whether :func:`make_paged_config` splits ``cfg``'s cache: a
    ``local_global`` config that asks for it (``kv_split_window``), with a
    window and layers of both kinds (a smoke reduction to its first two
    layers has no global one).  gemma3-1b does not ask: its one-pool
    allocator state is held to the JAX engine's bit for bit."""
    windows = layer_windows(cfg)
    return cfg.kv_split_window and cfg.attn_pattern == "local_global" \
        and bool(cfg.window) and FULL_WINDOW in windows \
        and windows.count(FULL_WINDOW) < len(windows)


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
    tokens (the JAX package's sizing).  Under ``swa`` the support core
    recycles the pages that slide out of the window, so the pool holds
    ``ceil(window / page_size) + 2`` live pages a lane and the stash is
    tuned to the window's recycling cadence; the block table still
    addresses all ``seq_len`` tokens.

    ``local_global`` splits the cache where :func:`splits_window` says so:
    ``kv_pages`` holds the global layers' K/V, every page live, sized and
    stash-tuned as full attention; the windowed layers' K/V goes to the
    window tenant, which recycles past the window and holds
    ``ceil(window / page_size) + 2`` live pages and a stash of the same
    size a lane (``window_pages``, rounded up to a multiple of 512 too).
    Unsplit, ``local_global`` sizes as full attention over every layer in
    one pool: its global layers keep every page live, so no page is
    recycled and the stash is tuned without a window (gemma3-1b, as the
    JAX package sizes it).

    Stash knobs left ``None`` are derived by :func:`autotune_stash`;
    ``scratch_slots=None`` means one workspace slot per lane.  The pool is
    rounded up to a multiple of 512 pages.  The hybrid family holds one KV
    layer per shared-block application (``num_layers // attn_every``) and
    one recurrent-state slot per lane (``state_slots``, a tenant between
    the KV pages and the scratch); the ssm family has the state slots too
    and one KV layer that no step writes, as in the JAX package.
    """
    pages_per_lane_addr = math.ceil((seq_len + 1) / page_size)
    split = splits_window(cfg)
    recycle = recycle_window(cfg)
    live_pages = pages_per_lane_addr if recycle is None \
        else math.ceil(recycle / page_size) + 2
    if stash_size is None or stash_watermark is None or stash_refill is None:
        pool0 = lanes * live_pages + slack_pages
        a_size, a_wm, a_rf = autotune_stash(page_size, recycle, lanes, pool0)
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
    window_layers: tuple = ()
    window_pages = 0
    if split:
        window_layers = tuple(i for i, w in enumerate(layer_windows(cfg))
                              if w != FULL_WINDOW)
        window_pages = lanes * (math.ceil(cfg.window / page_size) + 2
                                + stash_size) + slack_pages
        window_pages = -(-window_pages // 512) * 512
    return PagedKVConfig(
        num_kv_layers=max(cfg.num_attn_layers - len(window_layers), 1),
        kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        page_size=page_size,
        num_pages=num_pages,
        max_lanes=lanes,
        max_pages_per_lane=pages_per_lane_addr,
        dtype=dtype,
        state_slots=lanes if cfg.family in ("ssm", "hybrid") else 0,
        stash_size=stash_size,
        stash_watermark=stash_watermark,
        stash_refill=stash_refill,
        scratch_slots=lanes if scratch_slots is None else scratch_slots,
        split_window=cfg.window if split else 0,
        window_layers=window_layers,
        window_pages=window_pages,
    )
