"""Training launcher of the port: ``python -m repro_torch.launch.train``.

The JAX launcher's loop and flags (``repro.launch.train``): the
deterministic data pipeline, AdamW, gradient accumulation, async
checkpoints in the JAX package's format, the watchdog and restart on
failure.  ``--smoke`` trains the reduced same-family config in f32;
without it the published config trains in bf16.  ``--device`` picks
``cuda`` (default) or ``cpu``.

    python -m repro_torch.launch.train --arch gemma3-1b --smoke --device cpu
    python -m repro_torch.launch.train --arch gemma3-1b --steps 8 \\
        --seq-len 1024 --checkpoint-every 1000
"""
from __future__ import annotations

import argparse

import torch

from ..configs.base import ARCH_IDS, get_config, smoke_config
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Train one architecture of the port (JAX launcher's "
                    "loop and flags, plus --device).")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config in f32")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        grad_accum=args.grad_accum,
        batch_size=args.batch_size,
        seq_len=args.seq_len,
    )
    dtype = torch.float32 if args.smoke else torch.bfloat16
    report = Trainer(cfg, tcfg, dtype=dtype, device=args.device).run()
    print(f"done: steps={report.steps_run} final_loss={report.final_loss:.4f} "
          f"stragglers={report.straggler_steps} restarts={report.restarts} "
          f"on {args.device}")


if __name__ == "__main__":
    main()
