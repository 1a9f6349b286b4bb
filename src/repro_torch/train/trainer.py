"""Training loop: checkpoint/restart, watchdog, failure recovery (port of
:mod:`repro.train.trainer`).

The fault-tolerance contract of the JAX package:
  * periodic **async** checkpoints in its format
    (:mod:`repro_torch.distributed.checkpoint`), so either package resumes
    the other's run;
  * automatic **restore-on-start** from the newest intact checkpoint;
  * **deterministic data replay**: the pipeline is keyed by (seed, step,
    host), so a restart resumes the exact token stream (asserted);
  * **watchdog**: a step slower than ``straggler_factor`` x the trailing
    median of 20 counts as a straggler;
  * **retry loop**: an injected failure drains the in-flight checkpoint
    and restarts from the last one, up to ``max_restarts`` times.

The trainer turns the LM's gradients on (``requires_grad_(True)``); the
modules keep them off by default, so serving is unchanged.  A step's time
ends when its loss is read back to the host.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..data.pipeline import DataPipeline, TokenSource
from ..device import DeviceLike, resolve_device
from ..distributed.checkpoint import (AsyncCheckpointer, latest_step,
                                      restore_checkpoint)
from ..models.model_zoo import init_params, jax_layout, port_layout
from .optimizer import AdamW, AdamWState
from .train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0
    max_restarts: int = 3
    grad_accum: int = 1
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    log_every: int = 10


@dataclasses.dataclass
class TrainerReport:
    steps_run: int = 0
    restarts: int = 0
    restored_from: Optional[int] = None
    straggler_steps: int = 0
    final_loss: float = float("nan")
    step_times_ms: list = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)


def train_state_tree(params, opt_state: AdamWState,
                     device: DeviceLike = "cpu"):
    """``(params, AdamWState)`` in the JAX package's layout -- the tree its
    trainer checkpoints -- with every leaf moved to ``device`` (``"meta"``
    gives a restore template)."""
    def tree(named):
        return jax_layout({n: t.detach().to(device)
                           for n, t in named.items()})
    return (tree(dict(params.named_parameters())),
            AdamWState(step=opt_state.step.to(device), m=tree(opt_state.m),
                       v=tree(opt_state.v)))


def load_train_state(params, opt_state: AdamWState, tree) -> AdamWState:
    """Write a restored :func:`train_state_tree` into ``params`` (in place)
    and return the optimizer state it holds, on the parameters' device."""
    named = dict(params.named_parameters())
    p_tree, st = tree
    with torch.no_grad():
        for name, leaf in port_layout(p_tree, named).items():
            named[name].copy_(leaf)
    dev = opt_state.step.device
    return AdamWState(
        step=st.step.to(dev),
        m={n: t.to(dev) for n, t in port_layout(st.m, named).items()},
        v={n: t.to(dev) for n, t in port_layout(st.v, named).items()})


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig,
                 dtype: torch.dtype = torch.float32,
                 fail_injector: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.fail_injector = fail_injector  # (step) -> None; raises to fail
        self.optimizer = AdamW(lr=1e-3)
        self.step_fn = make_train_step(cfg, self.optimizer,
                                       grad_accum=tcfg.grad_accum)
        self.ckpt = AsyncCheckpointer(tcfg.checkpoint_dir,
                                      keep=tcfg.keep_checkpoints)
        self.report = TrainerReport()

    # -------------- state ----------------

    def init_state(self):
        params = init_params(self.cfg, seed=self.tcfg.seed, dtype=self.dtype,
                             device=self.device).requires_grad_(True)
        return params, self.optimizer.init(params), 0

    def restore_or_init(self):
        step = latest_step(self.tcfg.checkpoint_dir)
        params, opt_state, _ = self.init_state()
        if step is None:
            return params, opt_state, 0
        tree, _ = restore_checkpoint(
            self.tcfg.checkpoint_dir,
            train_state_tree(params, opt_state, "meta"), step=step)
        opt_state = load_train_state(params, opt_state, tree)
        self.report.restored_from = step
        return params, opt_state, step

    # -------------- loop ----------------

    def run(self) -> TrainerReport:
        restarts = 0
        while True:
            try:
                self._run_inner()
                break
            except _InjectedFailure:
                # drain any in-flight checkpoint before restarting, so the
                # restart sees the newest completed save
                self.ckpt.wait()
                restarts += 1
                self.report.restarts = restarts
                if restarts > self.tcfg.max_restarts:
                    raise RuntimeError("exceeded max_restarts")
        self.ckpt.wait()
        return self.report

    def _batch(self, batch: dict) -> dict:
        """numpy -> tensors on the device; patch and frame rows in the
        model's dtype."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v).to(self.device)
            out[k] = t.to(self.dtype) if t.is_floating_point() else t
        return out

    def _run_inner(self) -> None:
        tcfg = self.tcfg
        params, opt_state, start = self.restore_or_init()
        source = TokenSource(self.cfg, seed=tcfg.seed)
        pipeline = DataPipeline(source, global_batch=tcfg.batch_size,
                                seq_len=tcfg.seq_len, start_step=start)
        times: list[float] = []
        try:
            for step in range(start, tcfg.total_steps):
                batch = next(pipeline)
                if batch.pop("_step") != step:
                    raise RuntimeError("data replay misaligned")
                if self.fail_injector is not None:
                    self.fail_injector(step)
                t0 = time.monotonic()
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, self._batch(batch))
                loss = float(metrics["loss"])
                dt = (time.monotonic() - t0) * 1e3
                times.append(dt)
                self.report.step_times_ms.append(dt)
                self.report.losses.append(loss)
                # watchdog: straggler detection against the trailing median
                if len(times) >= 5:
                    med = statistics.median(times[-20:])
                    if dt > tcfg.straggler_factor * med:
                        self.report.straggler_steps += 1
                if (step + 1) % tcfg.checkpoint_every == 0 \
                        or step + 1 == tcfg.total_steps:
                    self.ckpt.save(train_state_tree(params, opt_state),
                                   step + 1)
                if (step + 1) % tcfg.log_every == 0:
                    print(f"step {step + 1}: loss={loss:.4f} ({dt:.0f} ms)",
                          flush=True)
                self.report.steps_run += 1
                self.report.final_loss = loss
        finally:
            pipeline.close()


class _InjectedFailure(RuntimeError):
    """Simulated preemption/node failure (tests)."""


def make_preemption_injector(fail_at_step: int):
    """Raise once at ``fail_at_step`` (simulates losing the job mid-run)."""
    fired = {"done": False}

    def inject(step: int):
        if step == fail_at_step and not fired["done"]:
            fired["done"] = True
            raise _InjectedFailure(f"simulated preemption at step {step}")

    return inject
