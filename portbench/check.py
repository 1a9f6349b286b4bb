"""What decides ``correct``: the program's served tokens against the plain
reference, and the allocator's state at the end of the run.

* ``logit_gap`` and ``logit_gap_mean``: a sample of the finished
  requests, drawn from the seed, with the one that holds the most tokens
  in it.  The reference runs once over each prompt with its served tokens
  (teacher-forced, float32 with TF32 off, weights drawn again from the
  seed) and reads, at every served position, how far the served token's
  logit lies below the reference's best.  The widest gap and the mean gap
  are compared with the mix's limits, each where the mix sets one (a
  number whose control reading does not stand three times above the
  program's has no limit: the widest gap of a top-2 MoE, whose routing
  flips under rounding).  A served token comes from the prefill (the
  first) or from a decode step through the paged cache (the rest), so the
  sample covers both kernels and, in an MoE cell, the experts.
* ``pool_pages_astray``: once every lane has been released, each class of
  the allocator holds every block once on its free stack, owned by no
  lane with no reference (limit 0).
* ``allocator_rejections``: admissions the allocator refused (limit 0).

With ``control`` the reference rounded to fp8 (:mod:`portbench.reference
.decoder`) is put in the program's place: at each sampled position the
token it ranks first is read against the reference's best, and those
gaps are judged against the same limits instead of the program's, so a
sound control run comes out not correct.  The program's own readings of
that run are kept beside them (``run.program_checks``), so one run gives
both readings a limit is set from.  The benchmark's own runs never pass
it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import weights as wts

#: the sample's seed stream, apart from the traffic's
SAMPLE_SALT = 0x5EED


def pool_astray(me) -> int:
    """Blocks not back on their free stack exactly once, or still owned or
    referenced, over every class, after every lane was released."""
    a = me.alloc
    stack = a.free_stack.cpu().numpy()
    top = a.free_top.cpu().numpy()
    owner = a.owner.cpu().numpy()
    ref = a.refcount.cpu().numpy()
    cap = a.capacity.cpu().numpy()
    bad = 0
    for c in range(stack.shape[0]):
        n = int(cap[c])
        free = stack[c, :int(top[c])]
        bad += n - len(set(free.tolist()) & set(range(n)))
        bad += len(free) - len(set(free.tolist()))
        bad += int((owner[c, :n] != -1).sum()) + int((ref[c, :n] != 0).sum())
    return bad


def sample(run, k: int) -> list:
    """``k`` finished requests drawn from the seed, the one with the most
    tokens first."""
    done = [r for r in run.reqs
            if r.request.state == "finished" and not r.truncated
            and r.n_out > 0
            and (run.mix["loop"] == "open" and r.item.segment == "window"
                 or run.mix["loop"] == "backlog" and r.done is not None
                 and r.done <= run.w_end)]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.item.prompt) + r.n_out)
    rest = [r for r in done if r is not longest]
    rng = np.random.RandomState((run.seed ^ SAMPLE_SALT) % (2 ** 32))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) \
        if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def gaps(run, ref, reqs: list, quant=None, against=None) -> tuple:
    """``(every gap, logits)``: each served token's gap below the
    reference's best (``against``: the reference's logits, computed
    before, against which this pass's first choices are read)."""
    model = run.model
    dtype = getattr(torch, model["dtype"])
    dev = run.device
    seqs = [np.concatenate([r.item.prompt,
                            np.asarray(r.request.output[:-1], np.int32)])
            for r in reqs]
    starts = [len(r.item.prompt) - 1 for r in reqs]
    logits = ref.served_logits(
        model, lambda: wts.draw_embed(model, run.seed, dtype, dev),
        lambda i: wts.draw_layer(model, run.seed, i, dtype, dev),
        lambda: wts.draw_head(model, run.seed, dtype, dev),
        seqs, starts, dev, quant=quant)
    out = []
    for i, (r, lg) in enumerate(zip(reqs, logits)):
        base = lg if against is None else against[i]
        pick = torch.as_tensor(r.request.output, device=lg.device).long() \
            if against is None else lg.argmax(-1)
        out.append(base.max(-1).values - base.gather(1, pick[:, None])[:, 0])
    return torch.cat(out).float().cpu(), logits


def gap_stats(g: torch.Tensor) -> dict:
    """Quantiles of a run's gaps, and the share of positions whose token
    is not the reference's first (gap above 0)."""
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99]))
    return {"n": len(g), "mean": float(g.mean()), "p50": float(q[0]),
            "p90": float(q[1]), "p99": float(q[2]), "max": float(g.max()),
            "share_over_0": float((g > 0).float().mean()),
            "share_over_0.1": float((g > 0.1).float().mean())}


def served_checks(g, lim: dict) -> dict:
    """The served tokens' numbers (``g``: their gaps, ``None`` when no
    request finished), each beside its limit where the mix sets one."""
    widest = math.inf if g is None else float(g.max())
    mean = math.inf if g is None else float(g.mean())
    out = {name: {"value": value, "limit": float(lim[f"{name}_limit"])}
           for name, value in (("logit_gap", widest), ("logit_gap_mean", mean))
           if f"{name}_limit" in lim}
    if not out:
        raise ValueError("the mix sets no limit on the served tokens")
    return out


def checks(run, ref, pool: int, rejected: int, control: bool = False
           ) -> dict:
    """``{name: {"value", "limit"}}``, each number compared with its
    limit; the run is correct when every value is at or under its limit.
    With ``control`` the served tokens' numbers are the fp8 control's."""
    lim = run.mix["check"]
    reqs = sample(run, int(lim["requests"]))
    g, logits = gaps(run, ref, reqs) if reqs else (None, None)
    run.checked_tokens = 0 if g is None else len(g)
    out = served_checks(g, lim)
    if control:
        cg = None if g is None else \
            gaps(run, ref, reqs, quant="fp8", against=logits)[0]
        if g is not None:
            run.gap_stats = {"program": gap_stats(g), "fp8": gap_stats(cg)}
        run.program_checks = out
        out = served_checks(cg, lim)
    out["pool_pages_astray"] = {"value": pool, "limit": 0}
    out["allocator_rejections"] = {"value": rejected, "limit": 0}
    return out


def correct(checks_: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks_.values())
