"""The four examples of the port (``examples/torch_*.py``), each run
in-process on the CPU through its ``main``, and held against the JAX
package where the example prints its numbers.

* ``torch_quickstart.py``: all six parts with their asserts (the chat's
  cache-on tokens equal the cache-off run's, three hits; aliased pages
  and no copied byte; the replay's counters equal the live run's; buddy's
  mean run length above the free list's).  Part 1's grants, counters and
  per-tenant use equal those of the JAX package's ``AllocService`` on the
  same burst, under the free list and the bitmap policy.
* ``torch_train_lm.py --small --steps 2``: two finite losses and a
  checkpoint.
* ``torch_serve_paged.py``: all eight requests served.
* ``torch_allocator_sim.py``: its Table 3 rows equal JAX's
  ``speedup_table`` under the same formatting.
"""
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CPU = ["--device", "cpu"]


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quickstart():
    return _example("quickstart").main(CPU)


def test_quickstart_runs_every_part_on_cpu(quickstart):
    q = quickstart
    assert len(q["losses"]) == 3 and all(map(math.isfinite, q["losses"]))
    assert len(q["tokens"]) == 9
    chat = q["engines"]["chat"].stats
    assert chat.cache_hits == 3 and chat.prefill_tokens_saved > 0
    alias = q["engines"]["alias"].stats
    assert alias.aliased_pages > 0 and alias.cache_hit_copy_bytes == 0
    assert q["report"].completed == 8
    assert q["trace"].header["complete"] and q["replay"].bursts == \
        q["trace"].bursts
    assert set(q["sims"]) == {"speedmalloc", "tcmalloc"}
    assert q["engines"]["buddy"].stats.mean_run_len > 1.0
    for eng in q["engines"].values():
        assert next(eng.params.parameters()).device.type == "cpu"


def test_quickstart_client_api_matches_jax(quickstart):
    """Part 1's burst through the JAX ``AllocService``: the same grants,
    counters and per-tenant use, and the bitmap policy's grant."""
    from repro.alloc import AllocService
    svc = AllocService(policy="freelist")
    kv = svc.register_tenant("kv_pages", capacity=8)
    ws = svc.register_tenant("workspace", capacity=16)
    burst = svc.new_burst()
    t_a = burst.malloc(kv, lane=0, n=2)
    t_b = burst.malloc(kv, lane=1, n=1)
    t_w = burst.malloc(ws, lane=0, n=4)
    burst.free_all(kv, lane=1)
    _, res = svc.commit(svc.init_state(), burst, max_blocks_per_req=4)
    bm = AllocService(policy="bitmap")
    bm_kv = bm.register_tenant("kv_pages", capacity=8)
    b2 = bm.new_burst()
    t2 = b2.malloc(bm_kv, lane=0, n=2)
    _, res2 = bm.commit(bm.init_state(), b2, max_blocks_per_req=4)

    def grant(r, t):
        return np.asarray(r.blocks_for(t))[0].tolist()
    s = res.stats
    got = quickstart["part1"]
    assert got["grants"] == {"lane0 kv": grant(res, t_a),
                             "lane1 kv": grant(res, t_b),
                             "lane0 ws": grant(res, t_w),
                             "bitmap lane0 kv": grant(res2, t2)}
    assert got["counters"] == {"mallocs": int(s.mallocs),
                               "frees": int(s.frees),
                               "failed": int(s.failed)}
    assert got["used"] == {t.name: int(s.per_tenant.used[t.size_class])
                           for t in svc.tenants}


def test_train_lm_small_two_steps(tmp_path):
    report = _example("train_lm").main(
        ["--small", "--steps", "2", "--checkpoint-dir", str(tmp_path)] + CPU)
    assert report.steps_run == 2
    assert len(report.losses) == 2 and all(map(math.isfinite,
                                               report.losses))
    assert (tmp_path / "step_00000002").is_dir()


def test_serve_paged_serves_every_request(capsys):
    _example("serve_paged").main(CPU)
    out = capsys.readouterr().out
    assert "served 8 requests in " in out and "on cpu" in out
    assert "fails=0" in out and "live=0" in out


def test_allocator_sim_rows_equal_jax(capsys):
    """Table 3's rows from the port's simulator equal JAX's
    ``speedup_table`` printed by the JAX example's format (each column is
    a ratio over jemalloc, so JAX needs only the four policies it
    prints).  JAX's trace scan runs under ``jax.jit`` with the policy and
    thread count static, one compile a policy, as in
    ``tests/test_torch_sim.py``: the same values, compiled once."""
    import jax
    from repro.sim import engine as jeng
    from repro.sim.policies import JEMALLOC, MIMALLOC, SPEEDMALLOC, TCMALLOC
    from repro.sim.workloads import MULTI_THREADED, PAPER_TABLE3
    text = _example("allocator_sim").main(CPU)
    capsys.readouterr()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng, "_run_trace",
                   jax.jit(jeng._run_trace, static_argnums=(0, 2)))
        table = jeng.speedup_table(list(MULTI_THREADED.values()),
                                   [JEMALLOC, TCMALLOC, MIMALLOC, SPEEDMALLOC],
                                   threads=16)
    want = []
    for wl, r in table.items():
        tc, mi, sp = PAPER_TABLE3[wl]
        want.append(f"{wl:11s} {r['tcmalloc']:6.2f} / {tc:4.2f} "
                    f"{r['mimalloc']:6.2f} / {mi:4.2f} "
                    f"{r['speedmalloc']:6.2f} / {sp:4.2f}")
    lines = text.splitlines()
    assert lines[2:2 + len(want)] == want
    assert "Fig. 17 ablation (vs tcmalloc):" in lines
