"""Work of the paged decode-attention op (``kernels/paged_attention``)
from the shapes of its calls: each active lane's live keys (the cached
tokens inside its window plus its own) read once as K and V, its query
read and its output written once.  Inactive lanes and the table's empty
slots are not work."""


def work(model: dict, live_keys: int, lane_steps: int,
         dtype_bytes: int = 2) -> tuple[float, float]:
    """``(flops, bytes)`` of every layer's call over ``lane_steps`` (lane,
    step) pairs whose live keys sum to ``live_keys``."""
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    L = model["num_layers"]
    flops = 4.0 * H * hd * live_keys * L
    nbytes = (2.0 * KV * hd * live_keys + 2.0 * H * hd * lane_steps) \
        * dtype_bytes * L
    return flops, nbytes
