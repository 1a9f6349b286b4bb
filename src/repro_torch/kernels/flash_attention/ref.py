"""Plain PyTorch version of flash prefill attention (port of the JAX
oracle ``repro.kernels.flash_attention.ref.flash_attention_ref``, which
delegates to the framework's naive attention)."""
from __future__ import annotations

from ...models.attention import naive_attention


def flash_attention_ref(q, k, v, *, causal=True, window=None, q_offset=0):
    """Query row i at absolute position ``q_offset + i`` (a prefill over a
    cached prefix of ``q_offset`` keys); key j at ``j``."""
    win = None if (window is None or window >= (1 << 29)) else window
    return naive_attention(q, k, v, causal=causal, window=win,
                           q_offset=q_offset)
