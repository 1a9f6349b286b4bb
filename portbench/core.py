"""The harness core: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``).  :func:`run_cell` builds the
configuration through the program's own API (weights from
:mod:`portbench.weights`, ``make_paged_config``, ``make_scheduler_config``,
a :class:`~repro_torch.serve.multi_engine.MultiEngine` with the mix's
engine settings), warms up on the mix, measures for ``seconds`` and
returns the run's :class:`Run` record; :func:`end_to_end` reduces it to
the end-to-end metrics and the readers under ``metrics/`` to the
per-layer ones.  Correctness (:mod:`portbench.check`) follows once the
window has closed.

The window is driven from the benchmark's side: requests are submitted
on a wall-clock schedule (:mod:`portbench.traffic`) between calls of
``MultiEngine.step_window``, and first and finished tokens are read after
each call, so a request's times count from when it was due and are
rounded up to the end of the window of decode steps that produced them.
The window opens at the first call boundary at or after its scheduled
start and closes at the first one at or after ``seconds`` later.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import traffic as tr
from . import weights as wts

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: seconds of the window the profiler records (its end), in a traced run
TRACE_SECONDS = 10.0
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------- files

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, man: dict, root: Path = ROOT
               ) -> tuple[dict, dict, dict]:
    """``(workload entry, configuration, traffic mix)`` of cell ``name``."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    return (w, load_json(root / conf["file"]),
            load_json(HERE / "traffic" / f"{w['traffic']}.json"))


def load_by_path(path: Path, name: str):
    """A module of the benchmark whose file name is a metric, kernel or
    configuration name (dots and dashes included)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_of(config_name: str):
    return load_by_path(HERE / "reference" / f"{config_name}.py",
                        f"portbench_reference_{config_name}")


#: a metric name may end in one of these to report its base reader's
#: quantity under a ``moves`` of its own (``decode_step_ms.open`` moves
#: ``tpot_p90_ms``, ``decode_step_ms`` the output rate)
VARIANTS = (".open_rate", ".open")


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``, or, where there is none, the file of the
    name without its variant suffix (:data:`VARIANTS`)."""
    path = HERE / "metrics" / f"{metric}.py"
    for suffix in VARIANTS:
        if not path.is_file() and metric.endswith(suffix):
            path = HERE / "metrics" / f"{metric[:-len(suffix)]}.py"
    return path


def reader_of(metric: str):
    return load_by_path(reader_path(metric), f"portbench_metric_{metric}")


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


# ---------------------------------------------------------------- records

@dataclasses.dataclass
class Req:
    """The benchmark's view of one request."""

    item: tr.Item
    request: object            # the program's Request
    due: float                 # absolute host time
    submitted: Optional[float] = None
    first: Optional[float] = None
    done: Optional[float] = None
    admitted: bool = False
    truncated: bool = False    # cut at the drain limit or at the close

    @property
    def n_out(self) -> int:
        return len(self.request.output)


@dataclasses.dataclass
class Window:
    """One ``step_window`` call."""

    t0: float
    t1: float = 0.0
    steps: list = dataclasses.field(default_factory=list)   # (s0, s1)
    step_us: list = dataclasses.field(default_factory=list)
    prompts: list = dataclasses.field(default_factory=list)  # admitted
    lane_steps: int = 0
    live_keys: int = 0
    tokens: int = 0            # output tokens it produced


@dataclasses.dataclass
class Run:
    """What one run measured and what the readers read."""

    cell: str
    model: dict
    mix: dict
    seed: int
    seconds: float
    device: str
    device_name: str
    windows: list = dataclasses.field(default_factory=list)
    reqs: list = dataclasses.field(default_factory=list)
    w_begin: float = 0.0
    w_end: float = 0.0
    first_window: int = 0      # index of the window's first call
    last_window: int = 0       # index past its last call
    t_start: float = 0.0       # process start
    setup_s: float = 0.0
    launches: dict = dataclasses.field(default_factory=dict)
    classes: int = 0
    pages: int = 0
    memory_peak_bytes: int = 0
    trace: Optional[dict] = None
    late_s: float = 0.0        # largest lag of a submission behind its due
    window_tokens: int = 0     # output tokens produced inside the window
    t_drained: float = 0.0     # when the drain after the window ended
    checked_tokens: int = 0    # served tokens the reference checked
    check_s: float = 0.0       # the reference's seconds, after the window
    gap_stats: Optional[dict] = None      # control runs: both sides' gaps
    program_checks: Optional[dict] = None  # control runs: the program's
    pool_pages: int = 0        # pages of the paged KV pool
    pages_in_use: int = 0      # most pages the window's running requests
                               # held, by their tokens after each call

    def window_calls(self, traced: bool = False) -> list:
        if traced and self.trace is not None:
            return self.windows[self.trace["first"]:self.trace["last"]]
        return self.windows[self.first_window:self.last_window]

    @property
    def window_s(self) -> float:
        return self.w_end - self.w_begin

    def due_in_window(self) -> list:
        return [r for r in self.reqs if r.item.segment == "window"]


# ---------------------------------------------------------------- program

def arch_config(model: dict):
    """The program's ``ArchConfig``: its registered configuration of the
    arch, with every size the configuration file states."""
    from repro_torch.configs import get_config
    base = get_config(model["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(base, **{k: v for k, v in model.items()
                                        if k in fields})


def build_program(model: dict, mix: dict, seed: int, device: str):
    """``(MultiEngine, its params)`` as the serve launcher builds it, with
    the benchmark's weights."""
    from repro_torch.models import abstract_params, make_paged_config
    from repro_torch.serve.multi_engine import MultiEngine
    from repro_torch.serve.scheduler import make_scheduler_config
    eng = mix["engine"]
    cfg = arch_config(model)
    dtype = getattr(torch, model["dtype"])
    params = abstract_params(cfg, dtype)
    params.load_state_dict(wts.state_dict(model, seed, dtype, device),
                           assign=True, strict=True)
    kvcfg = make_paged_config(cfg, seq_len=eng["seq_len"],
                              lanes=eng["lanes"], page_size=eng["page_size"],
                              dtype=dtype)
    scfg = make_scheduler_config(cfg, kvcfg,
                                 max_prompt_len=eng.get("max_prompt_len"))
    me = MultiEngine(cfg, kvcfg, params, n_engines=eng.get("engines", 1),
                     sched_cfg=scfg, quantum=eng.get("quantum", 4),
                     preemption=eng.get("preemption", False),
                     prefix_cache=eng.get("prefix_cache", False),
                     alloc_policy=eng.get("alloc_policy", "freelist"),
                     device=device)
    return me, params


def build_kernels() -> None:
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.flash_attention.ops import FLASH_KERNEL
    from repro_torch.kernels.paged_attention.ops import PAGED_KERNEL
    from repro_torch.kernels.support_core.ops import KERNEL
    build_all((KERNEL, PAGED_KERNEL, FLASH_KERNEL))


def launch_counts() -> dict:
    from repro_torch.kernels.flash_attention.ops import FLASH_KERNEL
    from repro_torch.kernels.paged_attention.ops import PAGED_KERNEL
    from repro_torch.kernels.support_core.ops import KERNEL
    return {"support_core": KERNEL.launches,
            "paged_attention": PAGED_KERNEL.launches,
            "flash_attention": FLASH_KERNEL.launches}


def slot_counts(me) -> int:
    """Support-core queue slots the engines and the windows have issued."""
    return sum(e.stats.burst_slots_capacity for e in me.engines) \
        + me.stats.window_slots_capacity


# ---------------------------------------------------------------- driving

class Driver:
    """Submits the schedule, drives ``step_window`` and keeps the
    records: each call's span, each decode step's span (the engines'
    ``step`` is wrapped for it), the prompts admitted and the keys the
    decode steps attended, and each request's first and last token.
    ``trace`` records the window's last ``trace_s`` with the profiler."""

    def __init__(self, run: Run, me, items: list, clock=time.perf_counter,
                 trace: bool = False):
        from repro_torch.serve.scheduler import Request
        self.run, self.me, self.clock = run, me, clock
        self.want_trace = trace
        self.prof = None
        self.pending: list[Req] = []
        self.live: list[Req] = []
        self.cur: Optional[Window] = None
        self._Request = Request
        self.items = items
        for eng in me.engines:
            self._wrap_step(eng)

    def _wrap_step(self, eng) -> None:
        inner = eng.step

        def step():
            s0 = self.clock()
            out = inner()
            if self.cur is not None:
                self.cur.steps.append((s0, self.clock()))
            return out
        eng.step = step

    def schedule(self, origin: float) -> None:
        for it in self.items:
            req = self._Request(rid=it.rid, tokens=it.prompt,
                                max_new_tokens=it.max_new_tokens)
            self.pending.append(Req(it, req, origin + it.due))
        self.pending.sort(key=lambda r: r.due)
        self.run.reqs = list(self.pending)
        self._next = 0

    def submit_due(self, now: float, most: Optional[int] = None) -> None:
        """Submit every request due by ``now`` (at most ``most``)."""
        batch = []
        while self._next < len(self.pending) \
                and self.pending[self._next].due <= now \
                and (most is None or len(batch) < most):
            r = self.pending[self._next]
            r.submitted = now
            if r.item.segment == "window":
                self.run.late_s = max(self.run.late_s, now - r.due)
            batch.append(r.request)
            self.live.append(r)
            self._next += 1
        if batch:
            self.me.submit(batch)

    @property
    def next_due(self) -> Optional[float]:
        if self._next < len(self.pending):
            return self.pending[self._next].due
        return None

    def window(self) -> Window:
        """One ``step_window`` call and its bookkeeping."""
        w = Window(t0=self.clock())
        self.cur = w
        before = {id(r): (r.n_out, r.request.state) for r in self.live}
        self.me.step_window(step_times_us=w.step_us)
        w.t1 = self.clock()
        self.cur = None
        window_size = self.run.model.get("window")
        page = self.me.kvcfg.page_size
        still = []
        in_use = 0
        for r in self.live:
            n0, st0 = before.get(id(r), (0, "waiting"))
            n1 = r.n_out
            w.tokens += n1 - n0
            admitted = st0 == "waiting" and r.request.state != "waiting"
            if admitted:
                r.admitted = True
                w.prompts.append(len(r.item.prompt))
            steps = n1 - n0 - (1 if admitted and n1 > n0 else 0)
            g = n0 + (1 if admitted else 0)      # generated before step 1
            P = len(r.item.prompt)
            for k in range(steps):
                pos = P + g + k - 1
                w.live_keys += pos + 1 if window_size is None \
                    else min(pos + 1, window_size)
            w.lane_steps += max(steps, 0)
            if n1 and r.first is None:
                r.first = w.t1
            if r.request.state in ("finished", "failed"):
                r.done = w.t1
            else:
                still.append(r)
                if r.request.state != "waiting":
                    held = -(-(P + n1) // page)
                    in_use += held if window_size is None \
                        else min(held, window_size // page + 1)
        self.live = still
        if self.run.w_begin and not self.run.w_end:       # in the window
            self.run.pages_in_use = max(self.run.pages_in_use, in_use)
        self.run.windows.append(w)
        return w

    def tokens(self) -> int:
        return sum(r.n_out for r in self.run.reqs if r.submitted is not None)

    # ------------------------------------------------ the traced span

    def trace_start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.run.trace = {"first": len(self.run.windows),
                          "launches0": launch_counts(),
                          "slots0": slot_counts(self.me)}
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.run.trace["t0"] = self.clock()
        self.run.trace["epoch_ns"] = time.time_ns() \
            - int(self.run.trace["t0"] * 1e9)

    def trace_stop(self) -> None:
        torch.cuda.synchronize()
        t = self.run.trace
        t["t1"] = self.clock()
        t["last"] = len(self.run.windows)
        l1 = launch_counts()
        t["launches"] = {k: l1[k] - t["launches0"][k] for k in l1}
        t["slots"] = slot_counts(self.me) - t["slots0"]
        self.prof.__exit__(None, None, None)

    # ------------------------------------------------ the loops

    def prime(self, prompts: list, vocab: int) -> None:
        """Serve one short request per prompt length, to completion, before
        the schedule starts: every prefill shape's first call (kernel
        loading, library handles, the caching allocator's first blocks)
        falls into set-up, not into the arrivals' warm-up."""
        rng = np.random.RandomState(len(prompts))
        reqs = [self._Request(rid=-1 - i, tokens=rng.randint(
            0, vocab, size=int(n)).astype(np.int32), max_new_tokens=4)
            for i, n in enumerate(prompts)]
        self.me.submit(reqs)
        while self.me.has_work:
            self.me.step_window()

    def open_loop(self, seconds: float, warmup_s: float, drain_s: float,
                  trace_s: float) -> None:
        run = self.run
        origin = self.clock() + warmup_s
        self.schedule(origin)
        close = trace_at = None
        begun = traced = False
        while True:
            now = self.clock()
            self.submit_due(now)
            if not begun and now >= origin:
                begun = True
                run.w_begin, run.first_window = now, len(run.windows)
                run.setup_s = now - run.t_start
                self.tokens0 = self.tokens()
                self.launches0 = launch_counts()
                close = now + seconds
                trace_at = close - trace_s
            if begun and self.want_trace and not traced and now >= trace_at:
                traced = True
                self.trace_start()
            if begun and now >= close:
                break
            if self.me.has_work:
                self.window()
                continue
            nxt = self.next_due
            wake = min(t for t in (nxt, origin, trace_at if self.want_trace
                                   and not traced else None, close)
                       if t is not None and (t > now or t == nxt))
            time.sleep(max(0.0, wake - self.clock()))
        self._close()
        limit = run.w_end + drain_s
        while self.me.has_work and self.clock() < limit:
            self.window()
        run.t_drained = self.clock()
        self.finish()

    def backlog(self, seconds: float, trace_s: float, per_call: int) -> None:
        """Every request is due at once; the warm-up hands the program
        ``per_call`` of them a call until the lanes are full (one admission
        holds all its prompts' K/V until its one burst), then the rest."""
        run = self.run
        self.schedule(self.clock())
        lanes = self.me.kvcfg.max_lanes * self.me.n_engines
        while self._next < len(self.pending) and sum(
                len(s.running) for s in self.me.scheds) < lanes:
            self.submit_due(self.clock(), most=per_call)
            self.window()
        self.submit_due(self.clock())
        run.w_begin, run.first_window = self.clock(), len(run.windows)
        run.setup_s = run.w_begin - run.t_start
        self.tokens0 = self.tokens()
        self.launches0 = launch_counts()
        close = run.w_begin + seconds
        traced = False
        while self.me.has_work:
            now = self.clock()
            if self.want_trace and not traced and now >= close - trace_s:
                traced = True
                self.trace_start()
            if now >= close:
                break
            self.window()
        self._close()
        run.t_drained = run.w_end
        self.finish()

    def _close(self) -> None:
        run = self.run
        run.w_end, run.last_window = self.clock(), len(run.windows)
        if self.prof is not None:
            self.trace_stop()
        self.tokens1 = self.tokens()
        l1 = launch_counts()
        run.launches = {k: l1[k] - self.launches0[k] for k in l1}

    def finish(self) -> None:
        """Cut every request still running at its next token and drop the
        waiting ones, then one more window: its merged commit frees every
        lane, so the pool must end empty."""
        for r in self.live:
            r.truncated = True
        for s in self.me.scheds:
            s.waiting.clear()
            for req in s.running.values():
                req.max_new_tokens = req.generated + 1
        if any(s.running for s in self.me.scheds):
            self.window()


# ---------------------------------------------------------------- a run

def prime_lengths(prompt: dict, scfg) -> list:
    """A prompt length for every prefill bucket the mix's prompts fall in
    (the longest of each), or, with exact-length buckets, the mix's
    shortest, median and longest."""
    lo, hi = int(prompt["lo"]), int(prompt["hi"])
    if scfg.exact_buckets:
        return sorted({lo, int(np.median(tr.lengths(prompt, 101))), hi})
    out, prev = [], 0
    for b in scfg.buckets:
        if b >= lo and prev < hi:
            out.append(min(b, hi))
        prev = b
    return out


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up: its first start loads
    CUPTI, seconds that would otherwise fall inside the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


def run_cell(cell: str, model: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             fault: Optional[Callable] = None,
             control: bool = False) -> tuple[Run, dict]:
    """Set up, warm up, measure and check one run.  Returns the record and
    the checks (:func:`portbench.check.checks`).  ``fault(me)`` breaks the
    program under the window (the fault tests)."""
    from . import check
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = Run(cell=cell, model=model, mix=mix, seed=seed, seconds=seconds,
              device=dev.type, device_name=name, t_start=t_start)
    ref = reference_of(model["name"])
    ref.check(model)
    if dev.type == "cuda":
        build_kernels()
        torch.cuda.reset_peak_memory_stats(dev)
    me, params = build_program(model, mix, seed, device)
    run.classes, run.pages = me.alloc.free_stack.shape
    run.pool_pages = int(me.kvcfg.num_pages)
    if fault is not None:
        fault(me)
    items = tr.schedule(mix, seed, seconds, model["vocab_size"])
    drv = Driver(run, me, items, trace=trace)
    if trace:
        warm_profiler()
    trace_s = min(TRACE_SECONDS, seconds)
    if mix["loop"] == "open":
        drv.prime(prime_lengths(mix["prompt"], me.scheds[0].scfg),
                  model["vocab_size"])
        drv.open_loop(seconds, float(mix.get("warmup_s", 0.0)),
                      float(mix.get("drain_s", 0.0)), trace_s)
    else:
        drv.backlog(seconds, trace_s,
                    int(mix.get("warmup", {}).get("per_call", 4)))
    run.window_tokens = drv.tokens1 - drv.tokens0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    pool = check.pool_astray(me)
    failed_alloc = sum(len(s.failed) for s in me.scheds)
    if run.trace is not None:
        from . import trace as trc
        trc.reduce(run, drv.prof)
    drv.prof = None
    del me, params, drv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check.checks(run, ref, pool, failed_alloc, control=control)
    run.check_s = time.perf_counter() - t0
    return run, checks


# ---------------------------------------------------------------- metrics

def end_to_end(run: Run) -> dict:
    """Every end-to-end metric the harness knows, by name.  The tails are
    over every request due in the window; one that failed, was cut at the
    drain limit or never produced a token counts with the least latency it
    could have had, from its due (or first token) to the drain's end, so
    it lies above every request served in time."""
    out = {"setup_s": run.setup_s,
           "output_tokens_per_s": run.window_tokens / run.window_s}
    due = run.due_in_window()
    if run.mix["loop"] == "open" and due:
        ttft, tpot = [], []
        for r in due:
            served = r.request.state == "finished" and not r.truncated
            first = r.first if r.first is not None else run.t_drained
            ttft.append((first - r.due) * 1e3)
            done = r.done if served else run.t_drained
            tpot.append((done - first) * 1e3 / max(r.n_out - 1, 1))
        out["ttft_p90_ms"] = tr.percentile(ttft, 90)
        out["tpot_p90_ms"] = tr.percentile(tpot, 90)
    return out


def attempted_failed(run: Run) -> tuple[int, int]:
    """Requests the window owed an answer, and those that got none in
    full: due in the window (open loop) or admitted by its close
    (backlog); failed when the allocator rejected them or, in an open
    loop, when they had not finished by the drain limit."""
    if run.mix["loop"] == "open":
        due = run.due_in_window()
        bad = [r for r in due if r.request.state != "finished"
               or r.truncated or r.first is None]
        return len(due), len(bad)
    started = [r for r in run.reqs if r.admitted]
    bad = [r for r in started if r.request.state == "failed"]
    return len(started), len(bad)


def per_layer(run: Run, entries: list) -> dict:
    out = {}
    for e in entries:
        v = reader_of(e["name"]).read(run)
        if v is not None:
            out[e["name"]] = v
    return out


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run must not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))
