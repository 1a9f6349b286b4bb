"""End-to-end training driver on the PyTorch port: lm-100m (162.4M
parameters by ``ArchConfig.param_count``, as in the JAX package) for a
few hundred steps on the full substrate (data pipeline, AdamW, grad
accumulation, async checkpointing, watchdog, restart-safety).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
      [--small] [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, TrainerReport


def lm_config(small: bool) -> ArchConfig:
    if small:
        return ArchConfig(name="lm-10m", family="dense", num_layers=4,
                          d_model=256, num_heads=4, num_kv_heads=4,
                          d_ff=1024, vocab_size=8192, head_dim=64)
    # 162.4M params (llama-style: a gated MLP, an untied head): 12L x d768
    # x ff3072, 32k vocab
    return ArchConfig(name="lm-100m", family="dense", num_layers=12,
                      d_model=768, num_heads=12, num_kv_heads=12, d_ff=3072,
                      vocab_size=32000, head_dim=64)


def main(argv=None) -> TrainerReport:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true",
                    help="lm-10m, 8.4M params (fast CPU demo), instead of "
                         "lm-100m")
    ap.add_argument("--checkpoint-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = lm_config(args.small)
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.1f}M params")

    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=50,
                         checkpoint_dir=args.checkpoint_dir,
                         batch_size=8, seq_len=256, grad_accum=2, log_every=10)
    report = Trainer(cfg, tcfg, dtype=torch.float32,
                     device=args.device).run()
    print(f"finished: steps={report.steps_run} "
          f"final_loss={report.final_loss:.4f} "
          f"stragglers={report.straggler_steps}")
    return report


if __name__ == "__main__":
    main()
