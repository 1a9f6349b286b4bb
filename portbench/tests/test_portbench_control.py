"""The control -- the plain reference with every linear layer rounded to
fp8 e4m3, put in the program's place -- must come out not correct through
the harness's own judgement, on each limit a cell sets (the widest gap
and the mean gap), here at a size a test run holds (the program in
float32 on the CPU reads 0).  On the card it is read at each cell's own
size with ``run.py --control 1``."""
import json
from pathlib import Path

import pytest

from portbench import check
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
TRAFFIC = ROOT / "portbench" / "traffic"


def _limits():
    """``(cell, limit)`` for every served-token limit of every cell."""
    out = []
    for w in MAN["workloads"]:
        lim = json.loads((TRAFFIC / f"{w['traffic']}.json").read_text())
        out += [(w["name"], name) for name in ("logit_gap", "logit_gap_mean")
                if f"{name}_limit" in lim["check"]]
    return out


@pytest.mark.parametrize("cell,limit", _limits(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_control_run_is_not_correct(cell, limit):
    kind = "moe" if cell.startswith("mixtral") else "dense"
    m = tiny.mix("backlog")
    m["check"] = {"requests": 100, f"{limit}_limit": 1e-3}
    run, checks = tiny.run(kind, "backlog", seconds=60, control=True,
                           mix_=m)
    # the program's own readings of the same run are sound
    assert check.correct(run.program_checks), run.program_checks
    assert run.program_checks[limit]["value"] == 0.0
    # the judged number is the control's, and it fails its limit
    assert set(checks) == {limit, "pool_pages_astray",
                           "allocator_rejections"}
    assert checks[limit]["value"] > checks[limit]["limit"]
    assert not check.correct(checks), checks
