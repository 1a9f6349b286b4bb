"""Boundary rules of the PyTorch port.

* No module of ``src/repro_torch``, not ``chip_smoke.py`` and none of the
  port's tools imports JAX or anything of the JAX package ``repro`` (an
  AST scan, so lazy imports inside functions count too).
* No module of ``src/repro_torch`` calls a library attention or compiler
  (``scaled_dot_product_attention``, cuDNN, ``torch.compile``): its
  kernels are written by hand.  ``chip_smoke.py`` may time one as a
  yardstick.
* No module of ``src/repro_torch`` reads an environment variable.
* Without a card, an entry point called without ``device="cpu"`` raises
  instead of falling back to the CPU.
* The kernel wrapper on CPU tensors runs the plain version and leaves its
  launch counter at 0.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
PORT_TOOLS = [ROOT / "tools" / name for name in (
    "decode_step_time.py", "flash_identity.py", "kernel_time.py",
    "prefill_hit_time.py", "profile_torch_serve.py")]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES + PORT_TOOLS,
                         ids=[str(p.relative_to(ROOT))
                              for p in PORT_FILES + PORT_TOOLS])
def test_port_imports_no_jax(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.parametrize("path", PORT_FILES[:-1],
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES[:-1]])
def test_port_calls_no_library_attention(path):
    used = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Attribute):
            used.add(node.attr)
            if node.attr == "compile" and isinstance(node.value, ast.Name) \
                    and node.value.id == "torch":
                used.add("torch.compile")
        elif isinstance(node, ast.Name):
            used.add(node.id)
    bad = used & {"scaled_dot_product_attention", "cudnn", "torch.compile",
                  "flash_attn"}
    assert not bad, f"{path.relative_to(ROOT)} uses {sorted(bad)}"


@pytest.mark.parametrize("path", PORT_FILES[:-1],
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES[:-1]])
def test_port_reads_no_environment(path):
    """Knobs that the JAX package reads from the environment
    (``REPRO_PREFIX_ALIAS``, ``REPRO_KV_EVICTION`` ...) are explicit
    arguments in the port."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("environ", "getenv", "environb"), \
                f"{path.relative_to(ROOT)} reads the environment"


def test_port_has_its_modules():
    """Every module of the slice sits under the JAX package's name."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES[:-1]}
    for mod in ("configs/base.py", "configs/deepseek_7b.py",
                "configs/gemma3_1b.py",
                "core/packets.py", "core/freelist.py", "core/hmq.py",
                "core/support_core.py", "core/lane_stash.py",
                "core/paged_kv.py", "kernels/_build.py",
                "kernels/support_core/ops.py", "kernels/support_core/ref.py",
                "kernels/paged_attention/ops.py",
                "kernels/paged_attention/ref.py",
                "kernels/flash_attention/ops.py",
                "kernels/flash_attention/ref.py", "alloc/policies.py",
                "alloc/service.py", "models/layers.py", "models/attention.py",
                "models/transformer.py", "models/decode.py",
                "models/model_zoo.py", "serve/serve_step.py",
                "serve/scheduler.py", "serve/engine.py", "launch/serve.py",
                "serve/router.py", "serve/multi_engine.py",
                "alloc/eviction.py"):
        assert mod in names, mod


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card rule is moot")
    from repro_torch.alloc import AllocService
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import main
    from repro_torch.models import init_params, make_paged_config
    from repro_torch.serve.engine import ServingEngine
    cfg = smoke_config("deepseek-7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        AllocService()
    params = init_params(cfg, dtype=torch.float32, device="cpu")
    kvcfg = make_paged_config(cfg, seq_len=32, lanes=2, page_size=4,
                              dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, kvcfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "deepseek-7b", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "deepseek-7b", "--requests", "1", "--engines", "2",
              "--prefix-cache", "on", "--prefix-alias", "alias"])
    from repro_torch.serve.multi_engine import MultiEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiEngine(cfg, kvcfg, params, n_engines=2)


def test_kernel_wrapper_on_cpu_uses_plain_version():
    from repro_torch.core.freelist import init_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,
                                          make_queue)
    from repro_torch.core.support_core import _step_scheduled_torch
    from repro_torch.kernels.support_core.ops import KERNEL, support_core_burst
    KERNEL.launches = 0
    state = init_freelist([6, 2])
    sched, _ = schedule(make_queue([OP_MALLOC, OP_MALLOC, OP_FREE],
                                   [0, 1, 0], [0, 1, 0], [3, 1, FREE_ALL]))
    for gated in (False, True):
        got = support_core_burst(state, sched, 3, gated=gated)
        want = _step_scheduled_torch(state, sched, 3, gated=gated)
        for a, b in zip((*got[0], got[1], got[2]),
                        (*want[0], want[1], want[2])):
            assert torch.equal(a, b)
    assert KERNEL.launches == 0
    assert KERNEL.lib is None        # nothing was built for the CPU path
