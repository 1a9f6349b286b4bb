#!/usr/bin/env python3
"""Device time of the MoE layer's two expert paths on one NVIDIA card:
the grouped products (``moe._grouped_apply``) and the capacity buffer
(``moe._moe_apply``), at a dropless capacity factor, in bf16.

    python3 tools/moe_paths_time.py

For mixtral-8x7b's experts (8 of 4096 -> 14336, top-2) and
mellum2-12b-a2.5b's (64 of 2304 -> 896, top-8), at token counts from a
decode step's (32, 64 lanes) to a prefill's, each path is captured once
as a CUDA graph and replayed: the time is the mean of 50 replays between
two CUDA events, so it is the device's, as in the decode graph.  One line
a size: the capacity buffer's rows (``E * C``), both times and their
ratio, and the experts' weight read at 3.35 TB/s, the floor of either.
``moe.GROUPED_MIN_ROWS`` comes from these lines.  Fails without a card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.models import moe  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
#: (name, experts, top-k, d_model, d_ff, token counts)
SHAPES = (("mixtral-8x7b", 8, 2, 4096, 14336, (32, 64, 128, 256, 512, 1024)),
          ("mellum2-12b-a2.5b", 64, 8, 2304, 896,
           (64, 96, 128, 256, 512, 1024)))


def graphed(fn) -> torch.cuda.CUDAGraph:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def replay_us(graph: torch.cuda.CUDAGraph, n: int = 50) -> float:
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n * 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("moe_paths_time: needs a CUDA card")
    torch.manual_seed(0)
    dev = torch.device("cuda")
    for name, E, K, d, ff, sizes in SHAPES:
        spec = moe.MoESpec(d, ff, E, K, capacity_factor=E / K)
        layer = moe.MoE(spec, torch.bfloat16, dev, None)
        layer.router.data.normal_(0, d ** -0.5)
        layer.w_in.data.normal_(0, d ** -0.5)
        layer.w_out.data.normal_(0, ff ** -0.5)
        floor = (layer.w_in.numel() + layer.w_out.numel()) * 2 \
            / HBM_BYTES_PER_S * 1e6
        for n in sizes:
            x = torch.randn((1, n, d), dtype=torch.bfloat16, device=dev)
            g = replay_us(graphed(lambda: moe._grouped_apply(layer, spec, x)))
            c = replay_us(graphed(lambda: moe._moe_apply(layer, spec, x)))
            rows = E * moe.expert_capacity(spec, n)
            print(f"{name} {n} tokens, buffer {rows} rows: grouped {g:.1f} "
                  f"us, capacity {c:.1f} us, ratio {g / c:.2f}; weight "
                  f"read {floor:.0f} us", flush=True)


if __name__ == "__main__":
    main()
