"""Work of the flash prefill op (``kernels/flash_attention``) from the
shapes of its calls: each admitted prompt of ``n`` tokens, causal within
the model's window (query ``i`` sees ``min(i + 1, window)`` keys), its Q,
K, V read once and its output written once.  Padding rows and padded
positions are not work."""


def attended_pairs(n: int, window) -> int:
    """Query-key pairs of a causal prompt of ``n`` tokens."""
    if window is None or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def work(model: dict, prompts: list, dtype_bytes: int = 2
         ) -> tuple[float, float]:
    """``(flops, bytes)`` of every layer's call over the admitted
    ``prompts`` (their lengths)."""
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    L, W = model["num_layers"], model.get("window")
    pairs = sum(attended_pairs(int(n), W) for n in prompts)
    tokens = sum(int(n) for n in prompts)
    flops = 4.0 * H * hd * pairs * L
    nbytes = (2.0 * H + 2.0 * KV) * hd * tokens * dtype_bytes * L
    return flops, nbytes
