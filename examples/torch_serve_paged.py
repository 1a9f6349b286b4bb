"""Serving example on the PyTorch port: scheduler-driven continuous
batching over the SpeedMalloc paged KV cache.  Requests flow through the
request-lifecycle scheduler: waiting queue -> prefill buckets -> running
lanes -> packet-routed release, with one support-core HMQ burst per
admission batch (DESIGN.md §3).  Every allocator touch goes through the
`repro_torch.alloc` client API -- the final telemetry includes the
per-tenant breakdown (KV pages, state slots, scratch workspace sharing the
one support-core -- DESIGN.md §9).  On the card the bursts, decode and
prefill attention are the hand-written CUDA kernels.

Run:  PYTHONPATH=src python examples/torch_serve_paged.py [--arch ARCH]
      [--device cpu]
      (try --arch zamba2-1.2b for all three tenants, or
       --alloc-policy bitmap for the first-fit AllocatorPolicy)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--arch" not in argv:
        argv += ["--arch", "mixtral-8x7b"]
    serve_main(argv + ["--requests", "8", "--lanes", "4",
                       "--max-new-tokens", "16"])


if __name__ == "__main__":
    main()
