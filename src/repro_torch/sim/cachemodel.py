"""Cache-pollution model of the allocator simulator: allocator metadata
competing with user data (port of :mod:`repro.sim.cachemodel`).

The formulas are scalars, so they run on the host in numpy float32: the
JAX package evaluates them as f32 arrays with weak-typed Python floats,
and each Python float here is cast to f32 before it meets an f32 value,
which is the same arithmetic under NumPy 1 and 2 alike.

  user_miss(C) = (ws / C)^alpha x 0.18      clipped to [0, 1], alpha 0.5
  pollution    = user_miss_cycles x amp x share^2,
                 share = md_ws / (md_ws + user_ws)

Anchors (paper Fig. 1): TCMalloc on BFS @16T -- metadata conflicts are
28.3% of all cache misses; SpeedMalloc removes 42%/19%/23% of L2 miss
cycles vs Je/TC/Mi-malloc (Fig. 10).
"""
from __future__ import annotations

import numpy as np

F32 = np.float32

L2_LINES = 4096.0          # 256 KB / 64 B (Table 2)
MISS_ALPHA = 0.5

#: pollution amplification (fit against paper Fig. 1c / Fig. 10 / Table 3)
POLLUTION_AMP = 10.0


def user_miss_rate(ws_lines, capacity_lines) -> np.float32:
    ws = F32(ws_lines)
    cap = np.maximum(F32(capacity_lines), F32(1.0))
    return np.clip((ws / cap) ** F32(MISS_ALPHA) * F32(0.18), F32(0.0),
                   F32(1.0))


def occupancy_share(md_ws_lines, user_ws_lines) -> np.float32:
    """Bounded [0,1) share of cache effectively lost to metadata."""
    md = F32(md_ws_lines)
    uw = np.maximum(F32(user_ws_lines), F32(1.0))
    return md / (md + uw)


def pollution_cycles_per_1k(user_miss_cycles, md_ws_lines, user_ws_lines,
                            amp: float = POLLUTION_AMP) -> np.float32:
    """Extra user stall cycles caused by metadata residency: quadratic in
    the occupancy share (bounded by ``amp`` x the user's own miss
    cycles)."""
    share = occupancy_share(md_ws_lines, user_ws_lines)
    return F32(user_miss_cycles) * F32(amp) * share * share
