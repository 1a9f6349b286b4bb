"""The plain decoder both configurations share: embedding, pre-norm
blocks of rotary attention (causal, optionally within a sliding window of
keys) and a SwiGLU MLP or a top-k mixture of SwiGLU experts with no token
dropped, final norm and the vocabulary projection.

Everything is computed in float32 with TF32 off, from the benchmark's own
weights (:mod:`portbench.weights`), drawn again one layer at a time, so
that a reference of a model that fills the card fits beside nothing else.
``quant="fp8"`` is the control: every linear layer's input rows and weight
columns are rounded to float8 e4m3 with a scale of their own, the rest as
above.

The conventions are the weights' (``x @ w``, ``[gate | up] = x @ w_in``,
RMSNorm ``x / rms(x) * (1 + scale)`` with eps 1e-6, rotate-half RoPE,
query ``i`` sees keys ``j`` with ``i - window < j <= i``).  Nothing here
imports the program.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

EPS = 1e-6
FP8_MAX = 448.0          # largest float8 e4m3 (fn) value
QUERY_BLOCK = 512


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) \
        * (1.0 + scale.float())


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the absolute max maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
           ) -> torch.Tensor:
    """``x [N, d_in] @ w [d_in, d_out]`` in float32 (the control: both
    rounded to fp8 first, ``x`` per row and ``w`` per output column)."""
    w = w.float()
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [T, heads, hd]`` rotated by absolute positions ``pos [T]``."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos[:, None].float() * inv
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int]) -> torch.Tensor:
    """Causal attention of one sequence: ``q [T, H, hd]``, ``k, v [T, KV,
    hd]`` -> ``[T, H * hd]``, in blocks of queries."""
    T, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)         # [H, T, hd]
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) / math.sqrt(hd)
    out = torch.empty((H, T, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, T, QUERY_BLOCK):
        q1 = min(T, q0 + QUERY_BLOCK)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        s = q[:, q0:q1] @ k[:, k0:q1].transpose(1, 2)          # [H, qb, kb]
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(k0, q1, device=q.device)[None, :]
        ok = kj <= qi
        if window is not None:
            ok &= kj > qi - window
        s = s.masked_fill(~ok, float("-inf"))
        out[:, q0:q1] = torch.softmax(s, dim=-1) @ v[:, k0:q1]
    return out.transpose(0, 1).reshape(T, H * hd)


def swiglu(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
           quant: Optional[str]) -> torch.Tensor:
    gate, up = linear(x, w_in, quant).chunk(2, dim=-1)
    return linear(F.silu(gate) * up, w_out, quant)


def experts(x: torch.Tensor, lw: dict, top_k: int, quant: Optional[str]
            ) -> torch.Tensor:
    """Top-k routing with no capacity: every token reaches its ``top_k``
    experts (ties to the lower index), whose outputs are summed weighted by
    the renormalised router probabilities."""
    gates = torch.softmax(x @ lw["moe.router"].float(), dim=-1)
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :top_k], top_e[:, :top_k]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(gates.shape[-1]):
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], lw["moe.w_in"][e], lw["moe.w_out"][e], quant)
            out.index_add_(0, rows, y * top_w[rows, slot, None])
    return out


def served_logits(model: dict, embed: Callable[[], torch.Tensor],
                  layer: Callable[[int], dict], head: Callable[[], dict],
                  seqs: list, starts: list, device,
                  quant: Optional[str] = None) -> list[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (ids), the float32 logits ``[n_i,
    V]`` at positions ``starts[i]`` .. ``len - 1``.

    ``embed()``, ``layer(i)`` and ``head()`` give the weights as
    :mod:`portbench.weights` names them; each is called once and dropped
    before the next."""
    device = torch.device(device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lens = [len(s) for s in seqs]
        ids = torch.as_tensor([int(t) for s in seqs for t in s],
                              device=device)
        pos = torch.cat([torch.arange(n, device=device) for n in lens])
        table = embed()
        x = table[ids].float()
        del table
        H, KV, hd = model["num_heads"], model["num_kv_heads"], \
            model["head_dim"]
        window = model.get("window")
        for li in range(model["num_layers"]):
            lw = layer(li)
            h = rmsnorm(x, lw["ln_attn"])
            q = rope(linear(h, lw["wq"], quant).view(-1, H, hd), pos,
                     model["rope_theta"])
            k = rope(linear(h, lw["wk"], quant).view(-1, KV, hd), pos,
                     model["rope_theta"])
            v = linear(h, lw["wv"], quant).view(-1, KV, hd)
            att = torch.cat([attention(q[a:a + n], k[a:a + n], v[a:a + n],
                                       window)
                             for a, n in zip(_offsets(lens), lens)])
            x = x + linear(att, lw["wo"], quant)
            h = rmsnorm(x, lw["ln_mlp"])
            if model.get("num_experts", 0) > 1:
                x = x + experts(h, lw, model["experts_per_token"], quant)
            else:
                x = x + swiglu(h, lw["w_in"], lw["w_out"], quant)
            del lw, h, q, k, v, att
        hw = head()
        out = []
        for a, n, s0 in zip(_offsets(lens), lens, starts):
            xs = rmsnorm(x[a + s0:a + n], hw["final_norm"])
            out.append(linear(xs, hw["unembed"], quant))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _offsets(lens: list) -> list:
    out, a = [], 0
    for n in lens:
        out.append(a)
        a += n
    return out
