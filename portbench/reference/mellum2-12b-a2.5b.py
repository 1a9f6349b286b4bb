"""Plain reference of mellum2-12b-a2.5b (JetBrains Mellum2 12B-A2.5B,
https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct, its
config.json): 28 pre-norm blocks in the pattern (sliding, sliding,
sliding, full) x 7, each of GQA attention (32 query heads on 4 KV heads
of 128) and a mixture of 64 SwiGLU experts of width 896, top-8 under a
softmax router with the top-8 probabilities renormalised, no shared
expert, in place of the MLP.  A sliding layer attends over the last 1024
positions with plain rotate-half RoPE at theta 500000; a full layer over
every earlier position with YaRN RoPE at the same theta (factor 16 over
8192 original positions, beta_fast 32, beta_slow 1: frequency ``i`` ramps
from ``theta^(-2i/d)`` below ``low`` to a sixteenth of it above
``high``, and cos and sin are scaled by the attention factor 1.2773).

Departures from the published model: its multi-token-prediction head is
not computed (serving here decodes one token a step, with no
speculation), and no QK-norm is applied (the config names none).  The
router drops no token, so the configuration runs the program at a
capacity factor of ``num_experts / experts_per_token``.

Computed as :mod:`portbench.reference.decoder` computes, in float32 with
TF32 off (``quant="fp8"``: the control), from its ``rmsnorm``,
``linear``, blocked ``attention`` and dropless ``experts``; the per-layer
windows and RoPE are this file's.  Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from portbench.reference.decoder import attention, experts, linear, rmsnorm


def check(model: dict) -> None:
    if model.get("attn_pattern") != "local_global" \
            or not model.get("window"):
        raise ValueError("mellum2-12b-a2.5b mixes sliding-window and full "
                         "layers (local_global with a window)")
    E, k = model["num_experts"], model["experts_per_token"]
    if model["moe_capacity_factor"] * k < E:
        raise ValueError(
            f"capacity factor {model['moe_capacity_factor']} can drop "
            f"tokens; the reference routes every token to its {k} experts")


def is_full(model: dict, layer: int) -> bool:
    """Whether layer ``layer`` attends over every earlier position."""
    period = model["local_per_global"] + 1
    return layer % period == model["local_per_global"]


def frequencies(model: dict, full: bool, device) -> tuple:
    """``(inverse frequencies [hd / 2], cos/sin scale)`` of a layer."""
    hd, theta = model["head_dim"], float(model["rope_theta"])
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=device) / hd))
    if not full or not model.get("yarn_factor"):
        return inv, 1.0
    L0 = model["yarn_original_max_position"]

    def dim(beta):
        return hd * math.log(L0 / (2 * math.pi * beta)) / (2 * math.log(theta))
    low = max(math.floor(dim(model["yarn_beta_fast"])), 0)
    high = min(math.ceil(dim(model["yarn_beta_slow"])), hd - 1)
    if high == low:
        high += 0.001
    i = torch.arange(hd // 2, dtype=torch.float32, device=device)
    ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
    inv = inv * (1.0 - ramp) + inv / model["yarn_factor"] * ramp
    return inv, float(model["yarn_attention_factor"])


def rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor,
         scale: float) -> torch.Tensor:
    """``x [T, heads, hd]`` rotated (split halves) by absolute positions
    ``pos [T]`` at ``inv``, cos and sin times ``scale``."""
    ang = pos[:, None].float() * inv
    sin, cos = torch.sin(ang)[:, None] * scale, torch.cos(ang)[:, None] * scale
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def served_logits(model: dict, embed: Callable[[], torch.Tensor],
                  layer: Callable[[int], dict], head: Callable[[], dict],
                  seqs: list, starts: list, device,
                  quant: Optional[str] = None) -> list[torch.Tensor]:
    """For each token sequence ``seqs[i]``, the float32 logits ``[n_i, V]``
    at positions ``starts[i]`` .. ``len - 1`` (the weights as
    :func:`portbench.reference.decoder.served_logits` takes them)."""
    device = torch.device(device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lens = [len(s) for s in seqs]
        offs = [sum(lens[:i]) for i in range(len(lens))]
        ids = torch.as_tensor([int(t) for s in seqs for t in s],
                              device=device)
        pos = torch.cat([torch.arange(n, device=device) for n in lens])
        table = embed()
        x = table[ids].float()
        del table
        H, KV, hd = model["num_heads"], model["num_kv_heads"], \
            model["head_dim"]
        for li in range(model["num_layers"]):
            full = is_full(model, li)
            inv, scale = frequencies(model, full, device)
            window = None if full else model["window"]
            lw = layer(li)
            h = rmsnorm(x, lw["ln_attn"])
            q = rope(linear(h, lw["wq"], quant).view(-1, H, hd), pos, inv,
                     scale)
            k = rope(linear(h, lw["wk"], quant).view(-1, KV, hd), pos, inv,
                     scale)
            v = linear(h, lw["wv"], quant).view(-1, KV, hd)
            att = torch.cat([attention(q[a:a + n], k[a:a + n], v[a:a + n],
                                       window)
                             for a, n in zip(offs, lens)])
            x = x + linear(att, lw["wo"], quant)
            x = x + experts(rmsnorm(x, lw["ln_mlp"]), lw,
                            model["experts_per_token"], quant)
            del lw, h, q, k, v, att
        hw = head()
        return [linear(rmsnorm(x[a + s0:a + n], hw["final_norm"]),
                       hw["unembed"], quant)
                for a, n, s0 in zip(offs, lens, starts)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


__all__ = ["served_logits", "check"]
