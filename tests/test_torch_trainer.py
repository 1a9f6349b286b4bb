"""The port's ``Trainer`` on the CPU: the JAX package's preemption test,
ported; a run resumed from a JAX checkpoint against the JAX ``Trainer``
resumed from the same one; the watchdog, the restart limit and the
launcher.  ``cuda``-marked twins hold the card against the CPU and skip
on a host without one.

Tolerances: the preempted run's final loss within 1e-4 of the
uninterrupted run's (the JAX test's bound); the port's per-step losses
from the JAX checkpoint within 1e-4 relative of the JAX trainer's (f32,
independent gradients through six AdamW steps).
"""
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.distributed.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.train.trainer import (Trainer, TrainerConfig,  # noqa: E402
                                       _InjectedFailure,
                                       make_preemption_injector)

ARCH = "deepseek-7b"


def _tcfg(path, **kw):
    base = dict(total_steps=10, checkpoint_every=4, checkpoint_dir=str(path),
                batch_size=4, seq_len=32, log_every=100)
    base.update(kw)
    return base


def test_preemption_recovery_and_determinism(tmp_path):
    cfg = smoke_config(ARCH)
    rep = Trainer(cfg, TrainerConfig(**_tcfg(tmp_path / "a")),
                  fail_injector=make_preemption_injector(6),
                  device="cpu").run()
    assert rep.restarts == 1
    assert rep.restored_from == 4
    assert np.isfinite(rep.final_loss)
    rep2 = Trainer(cfg, TrainerConfig(**_tcfg(tmp_path / "b")),
                   device="cpu").run()
    assert abs(rep2.final_loss - rep.final_loss) < 1e-4
    # steps 4 and 5 ran twice in the preempted run: 12 steps in all
    assert rep.steps_run == 12 and rep2.steps_run == 10


def test_resumes_a_jax_checkpoint_as_the_jax_trainer_does(tmp_path):
    """The JAX trainer runs 4 steps and checkpoints; from copies of that
    checkpoint the JAX trainer and the port's each run steps 4-9 over the
    same data.  The JAX package then restores the port's last
    checkpoint."""
    jcfg, cfg = j_smoke_config(ARCH), smoke_config(ARCH)
    JTrainer(jcfg, JTrainerConfig(**_tcfg(tmp_path / "j", total_steps=4))
             ).run()
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    jt = JTrainer(jcfg, JTrainerConfig(**_tcfg(tmp_path / "j")))
    j_losses = []
    step_fn = jt.step_fn

    def recording(*args):
        out = step_fn(*args)
        j_losses.append(float(out[2]["loss"]))
        return out
    jt.step_fn = recording
    jrep = jt.run()
    rep = Trainer(cfg, TrainerConfig(**_tcfg(tmp_path / "p")),
                  device="cpu").run()
    assert rep.restored_from == jrep.restored_from == 4
    assert len(rep.losses) == len(j_losses) == 6
    np.testing.assert_allclose(rep.losses, j_losses, rtol=1e-4)
    params = j_init_params(jcfg, dtype=jax.numpy.float32)
    restored, step = j_restore(tmp_path / "p", (params,
                                                JAdamW().init(params)),
                               process_index=0)
    assert step == 10 and int(restored[1].step) == 10


def test_watchdog_counts_a_straggler(tmp_path):
    """Steps of 50 ms and one of 600 ms (a step function that only waits,
    so the times hold on a loaded host): that one, and only it, counts
    against 3x the trailing median."""
    tr = Trainer(smoke_config(ARCH), TrainerConfig(**_tcfg(
        tmp_path, total_steps=8, checkpoint_every=100, seq_len=16)),
        device="cpu")
    calls = []

    def paced(params, opt_state, batch):
        calls.append(1)
        time.sleep(0.6 if len(calls) == 7 else 0.05)
        return params, opt_state, {"loss": torch.tensor(1.0)}
    tr.step_fn = paced
    rep = tr.run()
    assert rep.straggler_steps == 1
    assert len(rep.step_times_ms) == 8


def test_restarts_stop_at_max_restarts(tmp_path):
    def always(step):
        if step == 1:
            raise _InjectedFailure("preempted again")
    tr = Trainer(smoke_config(ARCH), TrainerConfig(**_tcfg(
        tmp_path, total_steps=3, seq_len=8, max_restarts=2)),
        fail_injector=always, device="cpu")
    with pytest.raises(RuntimeError, match="max_restarts"):
        tr.run()
    assert tr.report.restarts == 3


def test_launcher_trains_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--steps",
          "3", "--batch-size", "2", "--seq-len", "16", "--grad-accum", "2",
          "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    assert "done: steps=3" in out and "restarts=0" in out
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000002", "step_00000003"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(card):
    """``chip_smoke.py``'s phase 6a for every architecture: two f32 steps
    (TF32 off), the second with grad_accum=2 and compression, card against
    CPU within the tolerances of ``chip_smoke.train_device_vs_cpu``; no
    flash-kernel launch in a train step."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    for arch in ("deepseek-7b", "gemma3-1b", "zamba2-1.2b",
                 "phi3-medium-14b", "qwen2-72b", "phi-3-vision-4.2b",
                 "rwkv6-7b", "whisper-medium"):
        chip_smoke.train_device_vs_cpu(card, arch)


@pytest.mark.cuda
def test_serving_with_frozen_parameters_still_launches_the_kernel(card):
    """The serving forward holds frozen parameters: every attention layer
    launches the flash kernel, with grad mode on; a trainable model's
    serving forward raises instead of dropping the gradients."""
    from repro_torch.kernels.flash_attention.ops import FLASH_KERNEL
    from repro_torch.models import init_params
    from repro_torch.models.transformer import forward
    cfg = smoke_config("gemma3-1b")
    model = init_params(cfg, dtype=torch.bfloat16, device=card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    before = FLASH_KERNEL.launches
    forward(model, tokens)
    assert FLASH_KERNEL.launches - before == cfg.num_layers
    model.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        forward(model, tokens)
