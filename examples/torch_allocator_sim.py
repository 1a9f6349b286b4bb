"""Paper-claims reproduction on the PyTorch port in one command: Table 3 +
the Fig. 17 ablation.  On the card each simulated trace is one launch of
the hand-written trace kernel; on the CPU its plain event loop.

Run:  PYTHONPATH=src python examples/torch_allocator_sim.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.device import resolve_device
from repro_torch.sim.engine import geomean, speedup_table
from repro_torch.sim.policies import (IC_MALLOC, IC_PLUS_SIGNALS, JEMALLOC,
                                      MALLACC, MEMENTO, MIMALLOC, SPEEDMALLOC,
                                      SPEEDMALLOC_FULL, TCMALLOC)
from repro_torch.sim.workloads import MULTI_THREADED, PAPER_TABLE3


def main(argv=None) -> str:
    """Print Table 3 and the ablation; returns the printed text."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    lines = []

    def out(line: str = "") -> None:
        lines.append(line)
        print(line)

    pols = [JEMALLOC, TCMALLOC, MIMALLOC, MALLACC, MEMENTO, IC_MALLOC,
            SPEEDMALLOC]
    table = speedup_table(list(MULTI_THREADED.values()), pols, threads=16,
                          device=dev)

    out(f"{'workload':11s} {'tcmalloc':>14s} {'mimalloc':>14s} "
        f"{'speedmalloc':>14s}")
    out(f"{'':11s} {'sim / paper':>14s} {'sim / paper':>14s} "
        f"{'sim / paper':>14s}")
    for wl, r in table.items():
        tc, mi, sp = PAPER_TABLE3[wl]
        out(f"{wl:11s} {r['tcmalloc']:6.2f} / {tc:4.2f} "
            f"{r['mimalloc']:6.2f} / {mi:4.2f} {r['speedmalloc']:6.2f} / "
            f"{sp:4.2f}")
    gm = {p.name: geomean(r[p.name] for r in table.values()) for p in pols}
    out("\ngeomean speedup over jemalloc @ 16 threads:")
    for name, paper in [("tcmalloc", 1.48), ("mimalloc", 1.52),
                        ("speedmalloc", 1.75), ("mallacc", 1.42),
                        ("memento", 1.48)]:
        tag = " (calibrated)" if name in ("tcmalloc", "mimalloc") \
            else " (PREDICTED)"
        tag = "" if name == "speedmalloc" else tag
        out(f"  {name:12s} sim {gm[name]:.2f}x   paper {paper:.2f}x{tag}")

    abl = speedup_table(list(MULTI_THREADED.values()),
                        [JEMALLOC, TCMALLOC, IC_MALLOC, IC_PLUS_SIGNALS,
                         SPEEDMALLOC_FULL], threads=16, device=dev)
    tc = geomean(r["tcmalloc"] for r in abl.values())
    out("\nFig. 17 ablation (vs tcmalloc):")
    for n in ("ic-malloc", "ic+signals", "ic+signals+hmq"):
        out(f"  {n:16s} {geomean(r[n] for r in abl.values()) / tc:.2f}x")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
