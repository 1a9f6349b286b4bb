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
  instead of falling back to the CPU; the launchers print ``--help``.
* The kernel wrapper on CPU tensors runs the plain version and leaves its
  launch counter at 0.
* Every public name of the JAX package (top-level names, class members,
  package exports, launcher flags) has its twin in the port, except the
  names left out on purpose, which are ROADMAP.md's list.
"""
import ast
import functools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
PORT_TOOLS = [ROOT / "tools" / name for name in (
    "decode_step_time.py", "flash_identity.py", "kernel_time.py",
    "prefill_hit_time.py", "profile_torch_serve.py",
    "profile_torch_train.py", "trace_spans.py")] + [
    ROOT / "examples" / f"torch_{name}.py" for name in (
        "allocator_sim", "quickstart", "serve_paged", "train_lm")]


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
                "alloc/eviction.py", "loadgen/__init__.py",
                "loadgen/arrivals.py", "loadgen/workload.py",
                "loadgen/driver.py", "loadgen/trace.py",
                "launch/replay.py", "data/pipeline.py", "models/losses.py",
                "train/optimizer.py", "distributed/compression.py",
                "train/train_step.py", "distributed/checkpoint.py",
                "train/trainer.py", "launch/train.py", "sim/workloads.py",
                "sim/policies.py", "sim/cachemodel.py", "sim/costmodel.py",
                "sim/engine.py", "kernels/sim_trace/ref.py",
                "kernels/sim_trace/ops.py", "distributed/sharding.py",
                "distributed/hints.py", "launch/mesh.py", "launch/dryrun.py",
                "launch/roofline.py"):
        assert mod in names, mod


@pytest.mark.parametrize("launcher", ["serve", "replay", "train"])
def test_launchers_print_help(launcher):
    """The launchers parse ``--help`` (and exit 0) on a host without a
    card, through ``python -m`` as a user runs them."""
    import subprocess
    import sys
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--help"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert "usage:" in res.stdout
    for flag in {"serve": ("--alloc-policy", "--loadgen", "--rate",
                           "--priority-frac", "--shared-prefix-frac",
                           "--record-trace", "--max-windows"),
                 "replay": ("--policy", "--device", "--sim", "--threads"),
                 "train": ("--device", "--steps", "--grad-accum",
                           "--checkpoint-dir", "--smoke")}[launcher]:
        assert flag in res.stdout, flag


def test_entry_points_raise_without_card(tmp_path):
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
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiEngine(cfg, kvcfg, params, n_engines=2, alloc_policy="buddy")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "deepseek-7b", "--requests", "1", "--loadgen",
              "poisson", "--alloc-policy", "buddy"])
    from repro_torch.launch.replay import main as replay_main
    from repro_torch.loadgen import AllocTrace, replay_trace
    trace = AllocTrace(header={"version": 1, "policy": "buddy",
                               "backend": "jnp", "tenants": [["kv", 4]],
                               "traced_commits": 0, "complete": True},
                       events=[])
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_trace(trace)
    assert replay_trace(trace, device="cpu").bursts == 0
    from repro_torch.loadgen import save_trace
    save_trace(trace, tmp_path / "t.trc")
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_main([str(tmp_path / "t.trc")])
    from repro_torch.loadgen import replay_sim_policies
    from repro_torch.sim.costmodel import calibration_table
    from repro_torch.sim.engine import run_trace_counts, simulate
    from repro_torch.sim.policies import SPEEDMALLOC
    from repro_torch.sim.workloads import MULTI_THREADED
    with pytest.raises(RuntimeError, match="CUDA"):
        run_trace_counts(SPEEDMALLOC, {k: [0] for k in (
            "thread", "op", "size_class", "foreign")}, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(MULTI_THREADED["larson"], SPEEDMALLOC)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibration_table(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_sim_policies(trace)
    from repro_torch.launch.train import main as train_main
    from repro_torch.train.trainer import Trainer, TrainerConfig
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", "gemma3-1b", "--smoke", "--steps", "1",
                    "--checkpoint-dir", str(tmp_path / "ck")])
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainerConfig(checkpoint_dir=str(tmp_path / "ck")))
    assert not (tmp_path / "ck").exists()


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


def test_sim_kernel_wrapper_on_cpu_uses_plain_version():
    import numpy as np
    from repro_torch.kernels.sim_trace.ops import KERNEL, sim_trace
    from repro_torch.kernels.sim_trace.ref import run_trace_plain
    from repro_torch.sim.policies import ALL_POLICIES
    KERNEL.launches = 0
    ev = np.array([[0, 1, 1, 0], [1, 1, 2, 2], [3, 0, 0, 3], [0, 0, 1, 0]],
                  np.int32)
    sizes = torch.tensor([16, 32, 64, 128], dtype=torch.int32)
    for pol in ALL_POLICIES.values():
        got = sim_trace(torch.from_numpy(ev), 2, pol, sizes)
        want = run_trace_plain(ev, 2, pol, sizes.tolist())
        assert torch.equal(torch.stack(list(got)), torch.stack(list(want)))
    assert KERNEL.launches == 0
    assert KERNEL.lib is None        # nothing was built for the CPU path


JAX_SRC = ROOT / "src" / "repro"
PORT_SRC = ROOT / "src" / "repro_torch"

#: The Pallas kernels' modules: each one's twin is the CUDA source that
#: the kernel's ``ops.py`` builds and launches.
PALLAS_TWINS = {
    "kernels/support_core/support_core_kernel.py":
        "kernels/support_core/csrc/support_core.cu",
    "kernels/paged_attention/paged_attention.py":
        "kernels/paged_attention/csrc/paged_attention.cu",
    "kernels/flash_attention/flash_attention.py":
        "kernels/flash_attention/csrc/flash_attention.cu",
}

_COMPILES = "eager PyTorch compiles nothing, so there is nothing to count"
_BACKEND = ("the device picks between the kernel and the plain path; there "
            "is no backend knob")
_INIT = ("the port's nn.Modules build their own parameters, and "
         "params_from_numpy carries the JAX package's across")
_HLO = ("they read XLA's lowering and compiled HLO text and correct its "
        "count of a loop body; the port's eager dry run counts every layer "
        "and reads its collectives from the ops it runs")
_UNUSED_SIM = ("nothing calls it (simulate prices its own energy, cache "
               "occupancy and miss fraction)")

#: ``module``, ``module:Name``, ``module:Class.member`` or ``module:--flag``
#: -> why the port leaves it out.  Exactly ROADMAP.md's "Not ported, on
#: purpose" list.
NOT_PORTED = {
    "perf_flags.py": "the port reads no environment; each knob is an "
                     "argument with the JAX default",
    "serve/engine.py:EngineStats.decode_compiles": _COMPILES,
    "serve/engine.py:EngineStats.prefill_compiles": _COMPILES,
    "serve/engine.py:EngineStats.decode_compile_us": _COMPILES,
    "serve/multi_engine.py:MultiEngineStats.decode_compiles": _COMPILES,
    "serve/multi_engine.py:MultiEngineStats.decode_compile_us": _COMPILES,
    "serve/serve_step.py:CountingJit": _COMPILES,
    "core/paged_kv.py:PagedTenants.class_id_array":
        "the decode step shared across shards; eager PyTorch has no "
        "executable to share, so each shard builds its own step",
    "core/paged_kv.py:PagedTenants.with_class_ids":
        "the decode step shared across shards; eager PyTorch has no "
        "executable to share, so each shard builds its own step",
    "alloc/policies.py:AllocatorPolicy.backends": _BACKEND,
    "alloc/policies.py:FreeListPolicy.backends": _BACKEND,
    "alloc/policies.py:BitmapPolicy.backends": _BACKEND,
    "alloc/policies.py:BuddyPolicy.backends": _BACKEND,
    "alloc/service.py:AllocService.resolve_backend": _BACKEND,
    "core/support_core.py:ALLOC_BACKENDS": _BACKEND,
    "core/__init__.py:ALLOC_BACKENDS": _BACKEND,
    "launch/serve.py:--alloc-backend": _BACKEND,
    "launch/replay.py:--backend": _BACKEND,
    "alloc/service.py:AllocService.resolve_policy":
        "it reads perf_flags; the port's service takes its policy as an "
        "argument",
    "core/paged_kv.py:PagedKVConfig.state_dim":
        "a [state_slots, 1] f32 placeholder that nothing reads but its "
        "replicated sharding spec",
    "core/paged_kv.py:PagedKVState.lane_state":
        "a [state_slots, 1] f32 placeholder that nothing reads but its "
        "replicated sharding spec",
    "serve/serve_step.py:ServeState.step":
        "a step counter that only the decode step itself increments; "
        "nothing of the JAX package reads its value",
    "distributed/sharding.py:to_shardings":
        "XLA NamedShardings; the port places tensors with to_placements",
    "models/layers.py:init_mlp": _INIT,
    "models/layers.py:init_attention_proj": _INIT,
    "models/mamba2.py:init_mamba2": _INIT,
    "models/moe.py:init_moe": _INIT,
    "models/rwkv6.py:init_rwkv6": _INIT,
    "models/transformer.py:init_rwkv_block": _INIT,
    "launch/dryrun.py:SHAPE_RE": _HLO,
    "launch/dryrun.py:DTYPE_BYTES": _HLO,
    "launch/dryrun.py:COLLECTIVE_LINE_RE": _HLO,
    "launch/dryrun.py:GROUPS_BRACE_RE": _HLO,
    "launch/dryrun.py:GROUPS_IOTA_RE": _HLO,
    "launch/dryrun.py:parse_collective_bytes": _HLO,
    "launch/dryrun.py:build_lowering": _HLO,
    "launch/dryrun.py:analyze_compiled": _HLO,
    "launch/dryrun.py:extrapolate": _HLO,
    "launch/dryrun.py:--no-extrapolate": _HLO,
    "launch/roofline.py:ICI_BW":
        "the TPU's interconnect rate; the port's roofline uses the H100's "
        "NVLink rate, LINK_BW",
    "launch/roofline.py:CHIPS_SINGLE_POD":
        "the TPU pod's size; the port's roofline takes each mesh's own",
    "sim/costmodel.py:energy": _UNUSED_SIM,
    "sim/cachemodel.py:CacheStream": _UNUSED_SIM,
    "sim/cachemodel.py:metadata_occupancy": _UNUSED_SIM,
    "sim/cachemodel.py:metadata_miss_fraction":
        "nothing calls it, and it calls a function the reference never "
        "defines",
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _assigned(node) -> list[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    out = []
    for t in targets:
        for n in ([t] if isinstance(t, ast.Name) else
                  getattr(t, "elts", [])):
            if isinstance(n, ast.Name):
                out.append(n.id)
    return out


class _Module:
    """A module's surface, read from its source: what it defines, what it
    imports (and from where), its ``__all__`` and its classes."""

    def __init__(self, root: Path, rel: str):
        self.root, self.rel = root, rel
        self.defined, self.imported, self.classes = set(), {}, {}
        self.exported: list[str] = []
        self.flags: set[str] = set()
        tree = ast.parse((root / rel).read_text())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defined.add(node.name)
            elif isinstance(node, ast.ClassDef):
                self.defined.add(node.name)
                self.classes[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                names = _assigned(node)
                self.defined.update(names)
                if "__all__" in names:
                    self.exported = list(ast.literal_eval(node.value))
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    self.imported[a.asname or a.name] = (node.module,
                                                         node.level, a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.imported[(a.asname or a.name).split(".")[0]] = None
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and \
                    getattr(node.func, "attr", "") == "add_argument":
                self.flags.update(a.value for a in node.args
                                  if isinstance(a, ast.Constant)
                                  and str(a.value).startswith("--"))

    def names(self) -> set[str]:
        return self.defined | set(self.imported) | set(self.exported)

    def public_names(self) -> set[str]:
        """Top-level names a user reaches: defined ones, and a package's
        exports."""
        return {n for n in self.defined | set(self.exported)
                if _public(n) and n != "__all__"}

    def resolve(self, name: str):
        """``(module, ClassDef)`` of class ``name`` as this module sees it,
        following relative imports; None if it is no class of the package."""
        if name in self.classes:
            return self, self.classes[name]
        src = self.imported.get(name)
        if not src or not src[1]:
            return None
        module, level, orig = src
        base = Path(self.rel).parent
        for _ in range(level - 1):
            base = base.parent
        path = base.joinpath(*(module or "").split(".")) if module else base
        for rel in (path.with_suffix(".py"), path / "__init__.py"):
            if (self.root / rel).exists():
                return _module(self.root, str(rel)).resolve(orig)
        return None

    def members(self, name: str) -> set[str]:
        """Public members of class ``name``: its body's functions and
        attributes (NamedTuple and dataclass fields too), and its bases'."""
        found = self.resolve(name)
        if found is None:
            return set()
        mod, cls = found
        out = set()
        for b in cls.body:
            if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(b.name)
            elif isinstance(b, (ast.Assign, ast.AnnAssign)):
                out.update(_assigned(b))
        for base in cls.bases:
            if isinstance(base, ast.Name):
                out |= mod.members(base.id)
        return {m for m in out if _public(m)}


@functools.lru_cache(maxsize=None)
def _module(root: Path, rel: str) -> _Module:
    return _Module(root, rel)


def _jax_surface() -> dict[str, list[str]]:
    """``module -> keys`` of every public name of the JAX package."""
    surface = {}
    for path in sorted(JAX_SRC.rglob("*.py")):
        rel = str(path.relative_to(JAX_SRC))
        mod = _module(JAX_SRC, rel)
        keys = [f"{rel}:{n}" for n in sorted(mod.public_names())]
        for cls in sorted(c for c in mod.classes if _public(c)):
            keys += [f"{rel}:{cls}.{m}" for m in sorted(mod.members(cls))]
        keys += [f"{rel}:{f}" for f in sorted(mod.flags)]
        surface[rel] = keys
    return surface


def _port_lacks(key: str) -> bool:
    rel, _, name = key.partition(":")
    if not (PORT_SRC / rel).exists():
        return True
    if not name:
        return False
    mod = _module(PORT_SRC, rel)
    if name.startswith("--"):
        return name not in mod.flags
    cls, _, member = name.partition(".")
    if cls not in mod.names():
        return True
    return bool(member) and member not in mod.members(cls)


def _roadmap_not_ported() -> dict[str, str]:
    """ROADMAP.md's "Not ported, on purpose" bullets: ``- `key`, `key`:
    reason``, a reason wrapping onto indented lines."""
    text = (ROOT / "ROADMAP.md").read_text()
    section = text.split("**Not ported, on purpose.**", 1)[1]
    section = section.split("\n\n", 1)[0]
    bullets = re.split(r"\n- ", "\n" + section.split("\n", 1)[1])[1:]
    out = {}
    for bullet in bullets:
        m = re.fullmatch(r"((?:`[^`]+`(?:, )?)+): (.+)",
                         " ".join(bullet.split()), flags=re.S)
        assert m, f"ROADMAP.md: not a `key`: reason bullet: {bullet!r}"
        for key in re.findall(r"`([^`]+)`", m.group(1)):
            out[key] = m.group(2)
    return out


def test_port_has_the_public_names():
    """Every public top-level name, class member, package export and
    launcher flag of each JAX module exists in its port twin (parsed from
    source on both sides; nothing is imported), except ``NOT_PORTED``,
    which equals ROADMAP.md's list; the Pallas kernels' modules have their
    CUDA sources."""
    missing, stale = [], []
    surface = _jax_surface()
    for rel, keys in surface.items():
        if rel in PALLAS_TWINS:
            assert (PORT_SRC / PALLAS_TWINS[rel]).exists(), rel
            continue
        if rel in NOT_PORTED:
            assert not (PORT_SRC / rel).exists(), rel
            continue
        # a class left out takes its members with it
        missing += [k for k in keys if k not in NOT_PORTED
                    and k.rsplit(".", 1)[0] not in NOT_PORTED
                    and _port_lacks(k)]
    every_key = {k for keys in surface.values() for k in keys} | set(surface)
    stale = [k for k in NOT_PORTED if k not in every_key
             or not _port_lacks(k)]
    assert not missing, f"public JAX names the port lacks: {missing}"
    assert not stale, f"NOT_PORTED entries the port has or JAX lacks: {stale}"
    assert _roadmap_not_ported() == NOT_PORTED
