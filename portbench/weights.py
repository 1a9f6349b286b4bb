"""Seeded weights of a configuration, made by the benchmark itself.

One generator on the device per slot (the embedding, the head, each
layer), seeded from ``--seed`` and the slot, draws the slot's matrices in
one call into one flat buffer of the served dtype; each matrix is a view
of it scaled by ``1 / sqrt(fan_in)``.  The same call on the same device
gives the same values, so the program's weights (handed over once, at
set-up) and the reference's (drawn again, one slot at a time, after the
program is freed) are equal without either side reading the other's
tensors.

Names and layouts are the program's parameter names (``x @ w`` with ``w
[d_in, d_out]``; an MoE block's ``moe.router [d, E]`` in f32,
``moe.w_in [E, d, 2 * ff]``, ``moe.w_out [E, ff, d]``; RMSNorm scales
stored as ``scale - 1``, drawn as zeros).  Nothing here imports the
program.
"""
from __future__ import annotations

import math

import torch

#: slots per seed: the generator of slot ``s`` is seeded ``seed * SLOTS + s``
SLOTS = 4096
EMBED, HEAD = 0, 1


def layer_shapes(model: dict) -> list[tuple[str, tuple[int, ...]]]:
    """``[(name, shape)]`` of one layer's matrices in draw order (norms
    and the router apart)."""
    d, hd = model["d_model"], model["head_dim"]
    H, KV, ff = model["num_heads"], model["num_kv_heads"], model["d_ff"]
    out = [("wq", (d, H * hd)), ("wk", (d, KV * hd)), ("wv", (d, KV * hd)),
           ("wo", (H * hd, d))]
    E = model.get("num_experts", 0)
    if E > 1:
        out += [("moe.w_in", (E, d, 2 * ff)), ("moe.w_out", (E, ff, d))]
    else:
        out += [("w_in", (d, 2 * ff)), ("w_out", (ff, d))]
    return out


def _fan_in(shape: tuple[int, ...]) -> int:
    return shape[-2]


def _generator(seed: int, slot: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed * SLOTS + slot)


def draw_layer(model: dict, seed: int, layer: int, dtype: torch.dtype,
               device) -> dict[str, torch.Tensor]:
    """Layer ``layer``'s tensors, named without the ``layers.i.`` prefix."""
    device = torch.device(device)
    shapes = layer_shapes(model)
    sizes = [math.prod(s) for _, s in shapes]
    gen = _generator(seed, 2 + layer, device)
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        w = flat[off:off + n].view(shape)
        w.mul_(1.0 / math.sqrt(_fan_in(shape)))
        out[name] = w
        off += n
    d = model["d_model"]
    if model.get("num_experts", 0) > 1:
        E = model["num_experts"]
        router = torch.randn((d, E), generator=gen, dtype=torch.float32,
                             device=device)
        out["moe.router"] = router.mul_(1.0 / math.sqrt(d))
    out["ln_attn"] = torch.zeros((d,), dtype=dtype, device=device)
    out["ln_mlp"] = torch.zeros((d,), dtype=dtype, device=device)
    return out


def draw_embed(model: dict, seed: int, dtype: torch.dtype, device
               ) -> torch.Tensor:
    """``embed [V, d]``, unit normal."""
    device = torch.device(device)
    return torch.randn((model["vocab_size"], model["d_model"]),
                       generator=_generator(seed, EMBED, device), dtype=dtype,
                       device=device)


def draw_head(model: dict, seed: int, dtype: torch.dtype, device
              ) -> dict[str, torch.Tensor]:
    """``unembed [d, V]`` and ``final_norm [d]``."""
    device = torch.device(device)
    d = model["d_model"]
    w = torch.randn((d, model["vocab_size"]),
                    generator=_generator(seed, HEAD, device), dtype=dtype,
                    device=device)
    return {"unembed": w.mul_(1.0 / math.sqrt(d)),
            "final_norm": torch.zeros((d,), dtype=dtype, device=device)}


def state_dict(model: dict, seed: int, dtype: torch.dtype, device
               ) -> dict[str, torch.Tensor]:
    """Every tensor of the model under the program's parameter names."""
    sd = {"embed": draw_embed(model, seed, dtype, device),
          **draw_head(model, seed, dtype, device)}
    for i in range(model["num_layers"]):
        for name, t in draw_layer(model, seed, i, dtype, device).items():
            sd[f"layers.{i}.{name}"] = t
    return sd

