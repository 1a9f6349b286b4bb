#!/usr/bin/env python3
"""Bit-identity of two trees' flash prefill kernels on one NVIDIA card.

    python3 tools/flash_identity.py TREE_A TREE_B

Each tree (a checkout or a ``git archive`` of a commit that has
``repro_torch``) runs in its own process, builds its flash kernel from its
own sources (under ``TREE/build/kernels``) and computes the flash cases of
``chip_smoke.py`` phase 3 -- the JAX sweep, the ragged and serving shapes
and the bf16 edge cases, all with queries aligned to key 0 -- on inputs
drawn from fixed seeds.  Exits non-zero unless every output of the two
trees is bit-identical.  Prints the card's ``nvidia-smi`` line and the
case count.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (helpers only; imports no repro_torch)


def cases():
    """``(seed, B, Tq, H, KV, hd, causal, window, dtype, q_scale)``."""
    out = []
    for dt in (torch.float32, torch.bfloat16):
        for s in cs.FLASH_SWEEP:
            out.append((len(out), 2, s[0], *s[2:], dt, 1.0))
        for B, T, H, KV, hd, causal, w in (
                (2, 37, 4, 1, 256, True, 16), (1, 100, 2, 1, 16, True, cs.FULL),
                (4, 128, 32, 32, 128, True, cs.FULL),
                (4, 1536, 4, 1, 256, True, 512),
                (4, 1536, 4, 1, 256, True, cs.FULL)):
            out.append((len(out), B, T, H, KV, hd, causal, w, dt, 1.0))
    for T in (1, 63, 65, 200, 2048):
        for w in (1, 100, 512):
            for hd in (64, 128, 256):
                for G in (1, 4, 8):
                    out.append((len(out), 1, T, 2 * G, 2, hd, True, w,
                                torch.bfloat16, 8.0))
    return out


def dump(tree: str, path: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    outs = []
    for seed, B, T, H, KV, hd, causal, w, dt, scale in cases():
        rng = np.random.RandomState(seed)
        q = torch.as_tensor(rng.randn(B, T, H, hd).astype(np.float32)
                            * scale, device="cuda").to(dt)
        k, v = (torch.as_tensor(rng.randn(B, T, KV, hd).astype(np.float32),
                                device="cuda").to(dt) for _ in range(2))
        outs.append(flash_attention_op(q, k, v, causal=causal,
                                       window=w).cpu())
    torch.save(outs, path)


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--dump":
        dump(sys.argv[2], sys.argv[3])
        return
    if len(sys.argv) != 3 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, tree in enumerate(sys.argv[1:]):
            paths.append(str(Path(tmp) / f"{i}.pt"))
            subprocess.run([sys.executable, __file__, "--dump", tree,
                            paths[-1]], check=True)
        a, b = (torch.load(p) for p in paths)
    bad = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    if len(a) != len(b) or bad:
        raise SystemExit(f"flash outputs differ between the trees in cases "
                         f"{bad[:10]} of {len(a)}")
    print(f"flash identity: {len(a)} cases bit-identical between "
          f"{sys.argv[1]} and {sys.argv[2]}")


if __name__ == "__main__":
    main()
