"""The port's allocator simulator (``repro_torch.sim``) against the JAX
package's (``repro.sim``), on the CPU.

* ``run_trace_counts``: all nine counts bit for bit against JAX's
  ``lax.scan``, for every policy of ``ALL_POLICIES`` on four paper
  workloads at T = 1 and 16, on a trace with ``op`` values other than 1
  and 2, and on the empty trace.  An event outside ``[0, T)`` x
  ``[0, NUM_CLASSES)`` raises ``ValueError`` (JAX clamps the read and
  drops the write); ``make_trace`` never makes one.
* ``simulate``, ``speedup_table`` and ``calibration_table``: every float
  within 1e-5 relative of JAX's (the M/D/1 wait divides by ``2(1 - rho)``
  with rho clipped at 0.95, so an ulp of rho grows ~100x; the port in
  fact matches to the last bit here), at 16 threads on the multi-threaded
  workloads and at 1 thread on the single-threaded ones.
* The port's own versions of the eleven tests of ``tests/test_sim.py``:
  the paper's orderings, bands and ablation, and the stash policy's
  prediction of the port's serving engine's HMQ bursts.
* JAX's scan runs under ``jax.jit`` with the policy and the thread count
  static, so one compile serves every workload of a (policy, T) pair; its
  work is integer updates and float32 adds of 0 or 1, the same values
  with or without the outer ``jit``.
* On a card (``cuda`` marker; skipped here): the ``sim_trace`` kernel
  against its plain version, and the float32 saturation past 2**24
  events.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.sim import costmodel as jcost  # noqa: E402
from repro.sim import engine as jeng  # noqa: E402
from repro.sim import policies as jpol  # noqa: E402
from repro.sim import workloads as jwl  # noqa: E402
from repro_torch.kernels.sim_trace.ref import SimCounts  # noqa: E402
from repro_torch.sim import costmodel, engine, policies, workloads  # noqa: E402
from repro_torch.sim.engine import (geomean, run_trace_counts,  # noqa: E402
                                    simulate, speedup_table)
from repro_torch.sim.policies import (ALL_POLICIES, IC_MALLOC,  # noqa: E402
                                      IC_PLUS_SIGNALS, JEMALLOC, MALLACC,
                                      MEMENTO, MIMALLOC, SPEEDMALLOC,
                                      SPEEDMALLOC_FULL, TCMALLOC)
from repro_torch.sim.workloads import (MULTI_THREADED,  # noqa: E402
                                       SINGLE_THREADED)

POLS = [JEMALLOC, TCMALLOC, MIMALLOC, MALLACC, MEMENTO, IC_MALLOC, SPEEDMALLOC]
SINGLE_POLS = ["jemalloc", "tcmalloc", "speedmalloc", "speedmalloc-stash",
               "mallacc"]
#: small, high-foreign, pareto and uniform size mixes
SCAN_WORKLOADS = ["larson", "xmalloc", "alloctest", "bfs"]
RTOL = 1e-5
CPU = "cpu"

#: JAX's ``_run_trace``, compiled once per (policy, thread count)
jax_scan = jax.jit(jeng._run_trace, static_argnums=(0, 2))


def _jax_table(workload_specs, policy_names, threads):
    """JAX's ``speedup_table``, its scans through :data:`jax_scan`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng, "_run_trace", jax_scan)
        return jeng.speedup_table(
            workload_specs, [jpol.ALL_POLICIES[n] for n in policy_names],
            threads=threads)


def _trace(thread, op, size_class, foreign=None):
    n = len(op)
    return {"thread": np.asarray(thread, np.int32),
            "op": np.asarray(op, np.int32),
            "size_class": np.asarray(size_class, np.int32),
            "foreign": np.asarray(foreign if foreign is not None
                                  else np.zeros(n), np.int32)}


def _assert_counts_equal(got: SimCounts, want, what=""):
    for field in SimCounts._fields:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.float32 and g.dim() == 0, field
        assert g.device.type == "cpu", field
        assert g.numpy().tobytes() == w.astype(np.float32).tobytes(), \
            (what, field, float(g), float(w))


def _assert_close(got, want, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _assert_close(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{what}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), what
        assert abs(got - want) <= RTOL * abs(want), (what, got, want)
    else:
        assert got == want, (what, got, want)


# --------------------------------------------------------------------------
# the trace scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", list(jpol.ALL_POLICIES))
@pytest.mark.parametrize("threads", [1, 16])
@pytest.mark.parametrize("workload", SCAN_WORKLOADS)
def test_run_trace_counts_match_jax(workload, threads, policy):
    trace = jwl.make_trace(jwl.MULTI_THREADED[workload], 4096, threads)
    want = jax_scan(jpol.ALL_POLICIES[policy], trace, threads)
    got = run_trace_counts(ALL_POLICIES[policy], trace, threads, device=CPU)
    _assert_counts_equal(got, want, (workload, threads, policy))


def test_workloads_and_policies_are_the_jax_packages():
    """The copies hold the JAX package's values, and ``make_trace`` gives
    its arrays byte for byte, every event in range."""
    assert policies.ALL_POLICIES.keys() == jpol.ALL_POLICIES.keys()
    for name, pol in policies.ALL_POLICIES.items():
        assert tuple(pol) == tuple(jpol.ALL_POLICIES[name]), name
    assert policies.speedmalloc_stash(4, 2) == jpol.speedmalloc_stash(4, 2)
    for attr in ("PAPER_TABLE3", "PAPER_GEOMEAN", "INSTR_PER_ALLOC_OP",
                 "IPC_BASE", "NUM_CLASSES"):
        assert getattr(workloads, attr) == getattr(jwl, attr), attr
    np.testing.assert_array_equal(workloads.SIZE_CLASS_BYTES,
                                  jwl.SIZE_CLASS_BYTES)
    for ours, theirs in ((workloads.MULTI_THREADED, jwl.MULTI_THREADED),
                         (workloads.SINGLE_THREADED, jwl.SINGLE_THREADED)):
        for name, spec in ours.items():
            assert spec.__dict__ == theirs[name].__dict__, name
            assert spec.events_per_1k_instr == \
                theirs[name].events_per_1k_instr
            for T in (spec.threads, 16):
                got = workloads.make_trace(spec, 512, T)
                want = jwl.make_trace(theirs[name], 512, T)
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    assert got[k].tobytes() == want[k].tobytes(), (name, k)
                assert 0 <= got["thread"].min() and got["thread"].max() < T
                assert 0 <= got["size_class"].min() and \
                    got["size_class"].max() < workloads.NUM_CLASSES


def test_odd_ops_and_foreign_flags_match_jax():
    """``op`` values other than 1 and 2 still subtract their size from the
    live bytes, and only ``foreign == 1`` is foreign: JAX's arithmetic,
    under every policy."""
    trace = _trace(thread=[0, 1, 0, 1, 0, 2, 0, 1, 2, 0],
                   op=[1, 1, 0, 2, 3, 1, 2, 7, 2, 1],
                   size_class=[3, 3, 2, 3, 7, 0, 3, 5, 0, 3],
                   foreign=[0, 0, 0, 1, 0, 0, 2, 0, 1, 0])
    for name in jpol.ALL_POLICIES:
        want = jeng.run_trace_counts(jpol.ALL_POLICIES[name], trace, 3)
        got = run_trace_counts(ALL_POLICIES[name], trace, 3, device=CPU)
        _assert_counts_equal(got, want, name)
    got = run_trace_counts(SPEEDMALLOC, _trace([0, 0], [1, 0], [3, 2]), 1,
                           device=CPU)
    assert float(got.peak_bytes) == 128.0     # 128, then 128 - 64


def test_empty_trace_gives_the_initial_state():
    empty = _trace([], [], [])
    for name, pol in ALL_POLICIES.items():
        got = run_trace_counts(pol, empty, 16, device=CPU)
        assert all(float(x) == 0.0 for x in got), name
    want = jeng.run_trace_counts(TCMALLOC, empty, 16)
    _assert_counts_equal(run_trace_counts(TCMALLOC, empty, 16, device=CPU),
                         want)


@pytest.mark.parametrize("bad", [
    dict(thread=[0, 4], size_class=[0, 0]),
    dict(thread=[0, -1], size_class=[0, 0]),
    dict(thread=[0, 1], size_class=[0, 8]),
    dict(thread=[0, 1], size_class=[-1, 0]),
])
def test_out_of_range_events_raise(bad):
    trace = _trace(bad["thread"], [1, 2], bad["size_class"])
    with pytest.raises(ValueError, match="outside"):
        run_trace_counts(TCMALLOC, trace, 4, device=CPU)
    with pytest.raises(ValueError):
        run_trace_counts(TCMALLOC, {**trace, "op": np.ones(3, np.int32)}, 4,
                         device=CPU)


# --------------------------------------------------------------------------
# the cost model: the metric dicts
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def table16():
    return speedup_table(list(MULTI_THREADED.values()), POLS, threads=16,
                         device=CPU)


@pytest.fixture(scope="module")
def jax_table16():
    return _jax_table(list(jwl.MULTI_THREADED.values()),
                      [p.name for p in POLS], 16)


@pytest.fixture(scope="module")
def single_tables():
    return (speedup_table(list(SINGLE_THREADED.values()),
                          [ALL_POLICIES[n] for n in SINGLE_POLS], threads=1,
                          device=CPU),
            _jax_table(list(jwl.SINGLE_THREADED.values()), SINGLE_POLS, 1))


def _geo(table, name):
    return geomean(r[name] for r in table.values())


def test_simulate_metric_dicts_match_jax(table16, jax_table16):
    """Every float of the 70 cells, every speedup and every geomean
    within 1e-5 relative of JAX's."""
    _assert_close(table16, jax_table16, "table16")
    for p in POLS:
        want = jeng.geomean(r[p.name] for r in jax_table16.values())
        assert abs(_geo(table16, p.name) - want) <= RTOL * want, p.name


def test_single_threaded_metric_dicts_match_jax(single_tables):
    """The single-threaded specs take the f32 user-miss branch of the
    cost model (``user_miss_cycles == 0``)."""
    ours, theirs = single_tables
    _assert_close(ours, theirs, "single")


def test_calibration_table_matches_jax(table16, jax_table16):
    """``calibration_table(16)`` (its counts cached by the tables above on
    both sides) within 1e-5 of JAX's, and a cached cell equal to a fresh
    one."""
    _assert_close(costmodel.calibration_table(16, device=CPU),
                  jcost.calibration_table(16), "calibration")
    spec = MULTI_THREADED["larson"]
    cell = simulate(spec, SPEEDMALLOC, threads=16, device=CPU)
    engine._cached_counts.cache_clear()
    assert simulate(spec, SPEEDMALLOC, threads=16, device=CPU) == cell


def test_cost_formulas_match_jax():
    """``atomic_cost``, ``queue_wait`` (across the clip at 0.95) and
    ``replay_cycles`` on the same counts, bit for bit."""
    c = costmodel.DEFAULT_COSTS
    for n in (0.5, 1.0, 4.0, 11.75, 16.0):
        assert float(costmodel.atomic_cost(c, n)) == \
            float(jcost.atomic_cost(c, n))
    for rho in (0.0, 0.3, 0.7123, 0.9499, 0.95, 1.7):
        assert float(costmodel.queue_wait(14.0, rho)) == \
            float(jcost.queue_wait(14.0, rho)), rho
    trace = jwl.make_trace(jwl.MULTI_THREADED["larson"], 1024, 8)
    want = jeng.run_trace_counts(jpol.MALLACC, trace, 8)
    got = engine.host_counts(run_trace_counts(MALLACC, trace, 8, device=CPU))
    assert costmodel.replay_cycles(got, 8) == jcost.replay_cycles(want, 8)


# --------------------------------------------------------------------------
# the port's own versions of tests/test_sim.py
# --------------------------------------------------------------------------

def test_speedmalloc_beats_all_baselines_at_16t(table16):
    """Headline claim: SpeedMalloc > {Je, TC, Mi, Mallacc, Memento+} @ 16T."""
    sp = _geo(table16, "speedmalloc")
    for other in ("tcmalloc", "mimalloc", "mallacc", "memento", "ic-malloc"):
        assert sp > _geo(table16, other), other
    assert sp > 1.0


def test_geomeans_within_paper_bands(table16):
    """Software baselines calibrated; hardware policies are PREDICTIONS."""
    assert abs(_geo(table16, "tcmalloc") - 1.48) < 0.25
    assert abs(_geo(table16, "mimalloc") - 1.52) < 0.25
    assert abs(_geo(table16, "speedmalloc") - 1.75) < 0.30
    assert abs(_geo(table16, "mallacc") - 1.42) < 0.30
    assert abs(_geo(table16, "memento") - 1.48) < 0.30


def test_ic_malloc_loses_to_tcmalloc(table16):
    """Paper §6.4.2: harvesting an idle core cannot beat TCMalloc."""
    assert _geo(table16, "ic-malloc") < _geo(table16, "tcmalloc")


def test_fig17_ablation_ordering():
    """decoupled-only < +signals < +HMQ (Fig. 17)."""
    t = speedup_table(list(MULTI_THREADED.values()),
                      [JEMALLOC, IC_MALLOC, IC_PLUS_SIGNALS, SPEEDMALLOC_FULL],
                      threads=16, device=CPU)
    assert _geo(t, "ic-malloc") < _geo(t, "ic+signals") < \
        _geo(t, "ic+signals+hmq")


def test_scaling_with_threads():
    """SpeedMalloc's edge grows with thread count (paper Fig. 9 trend)."""
    gains = [_geo(speedup_table(list(MULTI_THREADED.values()),
                                [JEMALLOC, SPEEDMALLOC], threads=T,
                                device=CPU), "speedmalloc")
             for T in (2, 8, 16)]
    assert gains[0] < gains[-1]


def test_memory_consumption_flat(table16):
    """Fig. 12: SpeedMalloc within ~10% of TCMalloc/Mimalloc peak memory."""
    for wl, row in table16.items():
        cells = row["_cells"]
        sp = cells["speedmalloc"]["peak_bytes"]
        tc = cells["tcmalloc"]["peak_bytes"]
        assert sp < tc * 1.15, (wl, sp, tc)


def test_energy_savings(table16):
    """Fig. 13: energy(SpeedMalloc) < energy(software baselines) @ 16T."""
    for wl, row in table16.items():
        cells = row["_cells"]
        assert cells["speedmalloc"]["energy"] < cells["jemalloc"]["energy"]


def test_single_threaded_modest_gains(single_tables):
    """Fig. 8: single-threaded speedups exist but are small (~1.1x)."""
    sp = _geo(single_tables[0], "speedmalloc")
    assert 1.0 < sp < 1.5


def test_atomics_eliminated(table16):
    for wl, row in table16.items():
        assert row["_cells"]["speedmalloc"]["atomic_cycles"] == 0.0
        assert row["_cells"]["tcmalloc"]["atomic_cycles"] > 0.0


def test_stash_policy_registered_and_tiered():
    """speedmalloc_stash: central kind + local front tier; hits absorb most
    traffic, trips amortize by refill_batch."""
    from repro_torch.sim.policies import SPEEDMALLOC_STASH, speedmalloc_stash
    assert ALL_POLICIES["speedmalloc-stash"] is SPEEDMALLOC_STASH
    n = 64
    trace = _trace(np.zeros(n), np.ones(n), np.zeros(n))
    for refill in (2, 4, 8):
        cnt = run_trace_counts(speedmalloc_stash(16, refill), trace, 1,
                               device=CPU)
        assert float(cnt.shared_trips) == n / refill     # amortized pulls
        assert float(cnt.fast_hits) == n - n / refill


def test_stash_policy_cross_validates_serving_bursts(rng):
    """Sim<->serve cross-validation against the port's engine: the
    speedmalloc_stash policy's predicted HMQ-trip count for a scripted
    decode workload matches the port's measured admit + decode bursts."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params, make_paged_config
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.sim.policies import speedmalloc_stash

    page_size, stash, watermark, refill = 4, 8, 2, 4
    prompt_len, decode_steps = 8, 64

    cfg = smoke_config("deepseek-7b")
    kvcfg = make_paged_config(cfg, seq_len=prompt_len + decode_steps + 8,
                              lanes=1, page_size=page_size,
                              dtype=torch.float32, stash_size=stash,
                              stash_watermark=watermark, stash_refill=refill)
    eng = ServingEngine(cfg, kvcfg, init_params(cfg, dtype=torch.float32,
                                                device=CPU), device=CPU)
    assert eng.admit(0, rng.randint(0, cfg.vocab_size,
                                    size=prompt_len).astype(np.int32))
    for _ in range(decode_steps):
        eng.step()
    assert eng.stats.stash_misses == 0          # front tier absorbed them all
    assert eng.stats.hmq_admit_bursts == 1
    measured = eng.stats.hmq_admit_bursts + eng.stats.decode_bursts

    boundaries = sum(1 for s in range(decode_steps)
                     if (prompt_len + s) % page_size == 0)
    trace = _trace(np.zeros(boundaries), np.ones(boundaries),
                   np.zeros(boundaries))
    cnt = run_trace_counts(speedmalloc_stash(stash, refill), trace, 1,
                           device=CPU)
    predicted = 1 + float(cnt.shared_trips)     # 1 admission burst + refills
    assert abs(measured - predicted) <= 1, (measured, predicted)
    assert eng.stats.decode_bursts <= decode_steps / 5


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_sim_trace_kernel_matches_plain_on_card():
    """The kernel against its plain version, all nine counts bit for bit,
    for every policy on two workloads at T = 1, 16 and 4096 (the state in
    device memory) and on the empty trace; 2**24 + 8 mallocs read
    16777216.0 on the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.sim_trace.ops import KERNEL, sim_trace
    from repro_torch.kernels.sim_trace.ref import run_trace_plain
    dev = torch.device("cuda")
    sizes = [int(s) for s in workloads.SIZE_CLASS_BYTES]
    sizes_dev = torch.tensor(sizes, dtype=torch.int32, device=dev)
    cases = [np.zeros((4, 0), np.int32)]
    for name in ("larson", "alloctest"):
        for T in (1, 16, 4096):
            cases.append((engine._events(workloads.make_trace(
                MULTI_THREADED[name], 2048, T), T), T))
    for case in cases:
        ev, T = (case, 16) if isinstance(case, np.ndarray) else case
        for pol in ALL_POLICIES.values():
            before = KERNEL.launches
            got = sim_trace(torch.from_numpy(ev).to(dev), T, pol, sizes_dev)
            assert KERNEL.launches == before + 1
            want = run_trace_plain(ev, T, pol, sizes)
            assert torch.equal(torch.stack(list(got)).cpu(),
                               torch.stack(list(want))), (pol.name, T)
    n = (1 << 24) + 8
    sat = torch.zeros((4, n), dtype=torch.int32, device=dev)
    sat[1] = 1
    cnt = sim_trace(sat, 1, SPEEDMALLOC, sizes_dev)
    assert float(cnt.mallocs) == 16777216.0


def test_fit_workload_params_matches_jax():
    """The calibration fit (a grid and three refinement rounds over
    ``simulate``) lands on JAX's values for one workload."""
    got = costmodel.fit_workload_params("xmalloc", device=CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng, "_run_trace", jax_scan)
        want = jcost.fit_workload_params("xmalloc")
    _assert_close(got, want, "fit")
