"""Roofline over the port's dry-run records (port of
:mod:`repro.launch.roofline`).

Per (arch x shape) on a mesh, from rank 0's counts in
``results/dryrun_torch/`` (:mod:`repro_torch.launch.dryrun`):

  compute_s    = flops per device / PEAK_FLOPS
  memory_s     = bytes accessed per device / HBM_BW
  collective_s = collective wire bytes per device / LINK_BW

The eager step runs every layer, so the counts cover the full depth with
no extrapolation.  ``bytes_accessed`` is an unfused upper count (each
aten op's operands and results), so ``memory_s`` is an upper bound of a
fused step's.

MODEL_FLOPS = 6·N·D for train (N = params, MoE: active), 2·N·D for
inference shapes, plus the attention terms; model FLOPs per device over
the counted FLOPs exposes remat and redundant work.

Hardware constants: one NVIDIA H100 80GB HBM3 SXM at its 700 W power
limit, from NVIDIA's datasheet -- 989e12 FLOP/s dense bf16, 3.35e12 B/s
HBM3, and NVLink's 450e9 B/s per direction as the collective rate.  They
are datasheet peaks, not measurements; a card set below 700 W runs
slower.  Every row is a dry run of shapes: no cell here is a measured
time.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from ..configs.base import ARCH_IDS, SHAPES, get_config
from .dryrun import RESULTS_DIR

PEAK_FLOPS = 989e12     # dense bf16, H100 SXM datasheet, 700 W
HBM_BW = 3.35e12        # HBM3, H100 SXM datasheet
LINK_BW = 450e9         # NVLink 4, per direction, H100 SXM datasheet
HBM_GB = 80.0           # one card's memory (decimal GB, as the datasheet)


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs for the whole step (GLOBAL, all devices)."""
    shp = SHAPES[shape_name]
    return step_model_flops(get_config(arch), shp["kind"],
                            shp["global_batch"], shp["seq_len"])


def step_model_flops(cfg, kind: str, B: int, S: int) -> float:
    """:func:`model_flops` of ``cfg``'s step of ``kind`` over ``B``
    sequences of ``S`` tokens (decode: ``B`` lanes over ``S`` cached
    tokens)."""
    N = cfg.active_param_count()
    hd = cfg.resolved_head_dim

    def attn_flops(tokens, kv_len_avg):
        """QK^T + PV matmul flops for all attention layer instances."""
        n_attn = cfg.num_attn_layers
        if n_attn == 0:
            return 0.0
        return 4.0 * tokens * kv_len_avg * cfg.num_heads * hd * n_attn

    if kind == "train":
        D = B * S
        base = 6.0 * N * D
        attn = 3.0 * attn_flops(D, S / 2)     # fwd + 2x bwd
        if cfg.encoder_layers:
            base += 6.0 * 0.0                  # encoder params included in N
            attn += 3.0 * attn_flops(B * cfg.encoder_seq_len,
                                     cfg.encoder_seq_len)
        return base + attn
    if kind == "prefill":
        D = B * S
        return 2.0 * N * D + attn_flops(D, S / 2)
    # decode: one token per lane against seq_len KV
    D = B
    kv_len = min(S, cfg.window) if cfg.window else S
    return 2.0 * N * D + attn_flops(D, kv_len)


def load_cell(arch: str, shape: str, mesh: str = "pod16x16",
              results_dir: Optional[Path] = None) -> dict | None:
    p = Path(results_dir or RESULTS_DIR) / f"{arch}__{shape}__{mesh}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def roofline_row(arch: str, shape: str, mesh: str = "pod16x16",
                 results_dir: Optional[Path] = None,
                 record: Optional[dict] = None) -> dict:
    """One cell's roofline terms from its record (read from
    ``results_dir`` unless given)."""
    rec = record if record is not None else load_cell(arch, shape, mesh,
                                                      results_dir)
    row = {"arch": arch, "shape": shape, "mesh": mesh}
    if rec is None:
        row["status"] = "missing"
        return row
    row["status"] = rec["status"]
    if rec["status"] == "skipped":
        row["reason"] = rec.get("reason", "")
        return row
    if rec["status"] != "ok":
        row["reason"] = rec.get("error", "")[:120]
        return row

    dev = rec["per_device"]
    flops_dev = dev["flops"]
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = dev["bytes_accessed"] / HBM_BW
    collective_s = dev["collective_wire_total"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound_s = terms[dominant]

    mf = model_flops(arch, shape)
    mf_dev = mf / rec["ranks"]
    mem = dev["memory"]
    hbm_gb = (mem["argument_bytes"] + mem["temp_peak_bytes"]) / 1e9
    row.update({
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops_global": mf,
        "flops_dev": flops_dev,
        "useful_flops_ratio": mf_dev / flops_dev if flops_dev else 0.0,
        # useful work at peak over the time the dominant term implies
        "roofline_fraction": (mf_dev / PEAK_FLOPS) / bound_s if bound_s
        else 0.0,
        "hbm_gb_per_dev": hbm_gb,
        "fits_80gb": hbm_gb <= HBM_GB,
        "param_shard_max_bytes": mem["param_shard_max_bytes"],
        "dryrun_s": rec.get("seconds"),
    })
    return row


def full_table(mesh: str = "pod16x16",
               results_dir: Optional[Path] = None) -> list[dict]:
    return [roofline_row(a, s, mesh, results_dir)
            for a in ARCH_IDS for s in SHAPES]


def advice(row: dict) -> str:
    """One sentence on what would move the dominant term down."""
    if row.get("status") != "ok":
        return ""
    d = row["dominant"]
    if d == "collective":
        return ("reduce cross-device traffic: fewer FSDP re-gathers "
                "(larger microbatch / weight-stationary), shard-local paged "
                "pools, or reduce-scatter instead of all-reduce")
    if d == "memory":
        return ("cut HBM traffic: fuse gather+attention (the paged kernel), "
                "keep f32 temporaries out of the residual path, larger "
                "attention chunks")
    return ("raise tensor-core utilization: bigger per-device tiles (less "
            "TP), reduce remat recompute, batch small matmuls")


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant | "
           "useful/counted | roofline frac | HBM GB | fits 80 GB |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ? | ? | ? | "
                         f"{r.get('status')} | ? | ? | ? | ? |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"**{r['dominant']}** | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {r['hbm_gb_per_dev']:.1f} | "
            f"{'y' if r['fits_80gb'] else 'N'} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--mesh", default="pod16x16",
                    choices=["pod16x16", "pod2x16x16"])
    args = ap.parse_args(argv)
    rows = full_table(args.mesh)
    if args.json:
        print(json.dumps(rows, indent=1))
        return
    print(markdown_table(rows))
    ok = [r for r in rows if r.get("status") == "ok"]
    if ok:
        worst = min(ok, key=lambda r: r["roofline_fraction"])
        coll = max(ok, key=lambda r: r["collective_s"]
                   / max(r["compute_s"], 1e-9))
        print(f"\nworst roofline fraction: {worst['arch']} x {worst['shape']} "
              f"({worst['roofline_fraction']:.3f})")
        print(f"most collective-bound: {coll['arch']} x {coll['shape']} "
              f"(coll/comp = "
              f"{coll['collective_s'] / max(coll['compute_s'], 1e-9):.1f}x)")
        for r in ok:
            if r["dominant"] != "compute":
                print(f"  {r['arch']} x {r['shape']}: {r['dominant']}-bound "
                      f"-> {advice(r)}")


if __name__ == "__main__":
    main()
