"""Sharding hints and the sharded steps of the port
(``repro_torch.distributed.hints``) against the JAX package and the
unsharded port, on the CPU.

* ``moe_apply`` with G = 2 and 4 dispatch groups equals JAX's under a
  test-side hints object whose ``moe_groups()`` is G (its other hints
  return their input), keep masks included: f32 smoke mixtral and
  phi3.5-moe, with drops (capacity factor 1.0) and without (4.0).
* With ``NO_HINTS`` every hint returns its input.
* On a 2x2 mesh with real collectives (a gloo group of 4 processes,
  ``tests/_mesh_worker.py``): smoke deepseek-7b's decode step and
  prefill give the unsharded port's logits within 1e-5 and its tokens;
  smoke mixtral's prefill at G = 2 (capacity factor 1.0, so pairs drop)
  gives JAX's at G = 2; a tuple of axes shards pod-major.
* A one-rank mesh (the card's route) serves the unsharded engine's
  tokens with the same allocator counts.
"""
import dataclasses
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.core.hmq import round_robin_rank as j_rank  # noqa: E402
from repro.distributed.hints import use_hints as j_use_hints  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.distributed.hints import (NO_HINTS, ShardingHints,  # noqa: E402
                                           current_hints, use_hints)
from repro_torch.models import make_paged_config, moe  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serve import serve_step as ss  # noqa: E402

import _mesh_worker as mw  # noqa: E402

MOE_ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")


class GroupHints:
    """JAX-side hints: ``moe_groups()`` is G, every other hint returns its
    input (nothing of the JAX package changes)."""

    def __init__(self, groups: int):
        self.groups = groups

    def moe_groups(self) -> int:
        return self.groups

    def __getattr__(self, name):
        return lambda x, *a: x


def _j_keep(jp, spec, x, G):
    """JAX's keep mask ``[G, n*K]`` as its ``moe_apply`` computes it."""
    n = x.shape[0] * x.shape[1] // G
    xf = x.reshape(G, n, -1)
    gates = jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], axis=-1)
    _, top_e = jax.lax.top_k(gates, spec.experts_per_token)
    choice = top_e.reshape(G, -1)
    rank = jax.vmap(j_rank)(choice, jnp.ones_like(choice, dtype=bool))
    return np.asarray(rank < jmoe.expert_capacity(jmoe.MoESpec(*spec), n))


@pytest.mark.parametrize("cf", [1.0, 4.0])
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_groups_match_jax(arch, G, cf):
    spec = moe.spec_of(dataclasses.replace(smoke_config(arch),
                                           moe_capacity_factor=cf))
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jmoe.MoESpec(*spec),
                       jnp.float32)
    tp = moe.MoE(spec, torch.float32, torch.device("cpu"), None)
    for name, p in tp.named_parameters():
        p.data = torch.from_numpy(np.array(jp[name]))
    rng = np.random.RandomState(4)
    x = (rng.randn(4, 24, spec.d_model) + 2.0 * rng.randn(spec.d_model)
         ).astype(np.float32)
    with j_use_hints(GroupHints(G)):
        want = np.asarray(jmoe.moe_apply(jp, jmoe.MoESpec(*spec),
                                         jnp.asarray(x)))
    j_keep = _j_keep(jp, spec, jnp.asarray(x), G)
    with use_hints(ShardingHints({"data": G, "model": 1})):
        assert current_hints().moe_groups() == G
        got = moe.moe_apply(tp, spec, torch.from_numpy(x)).numpy()
    xt = torch.from_numpy(x).reshape(G, -1, spec.d_model)
    gates = torch.softmax(xt @ tp.router, dim=-1)
    C = moe.expert_capacity(spec, xt.shape[1])
    _, _, _, keep = moe._dispatch(xt, gates, spec.experts_per_token, C)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    assert (0 < (~j_keep).sum()) == (cf == 1.0)      # drops only at 1.0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_no_hints_return_their_input():
    x4 = torch.randn(2, 4, 3, 8)
    x3 = torch.randn(2, 4, 8)
    h = NO_HINTS
    for out, x in ((h.residual(x3), x3), (h.logits(x3), x3),
                   (h.lanes(x3), x3), (h.microbatches(x3), x3),
                   (h.gathered_kv(x4, 3), x4), (h.expert_buffer(x4), x4),
                   (h.expert_buffer_local(x4), x4)):
        assert out is x
    assert h.moe_groups() == 1
    assert current_hints() is NO_HINTS


def _save_tree(tree, path: Path) -> None:
    flat = {}

    def walk(sub, prefix):
        for k, v in sub.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)
    walk(tree, ())
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The 4 ranks' outputs, the weights' JAX trees and configs."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh")
    trees, cfgs, weights = {}, {}, {}
    for arch in ("deepseek-7b", "mixtral-8x7b"):
        jcfg = j_smoke_config(arch)
        if arch == "mixtral-8x7b":
            jcfg = dataclasses.replace(jcfg, moe_capacity_factor=1.0)
        trees[arch] = j_init_params(jcfg, seed=5, dtype=jnp.float32)
        cfgs[arch] = jcfg
        weights[arch] = str(tmp / f"{arch}.npz")
        _save_tree(trees[arch], Path(weights[arch]))
    out = tmp / "out.pt"
    mp.start_processes(mw.run, args=(str(tmp / "store"), str(out), weights),
                       nprocs=4, start_method="spawn", join=True)
    return torch.load(out, weights_only=False), trees, cfgs


def _port_params(trees, arch):
    cfg = smoke_config(arch)
    if arch == "mixtral-8x7b":
        cfg = dataclasses.replace(cfg, moe_capacity_factor=1.0)
    tree = jax.tree.map(np.asarray, trees[arch])
    return cfg, params_from_numpy(tree, cfg, dtype=torch.float32,
                                  device="cpu")


def test_tuple_of_axes_shards_pod_major(mesh_run):
    got, _, _ = mesh_run
    # rank (pod i, data j) holds block i * 2 + j
    assert got["pod_major"] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_sharded_decode_matches_unsharded(mesh_run):
    got, trees, _ = mesh_run
    cfg, params = _port_params(trees, "deepseek-7b")
    kv = make_paged_config(cfg, 64, mw.LANES, page_size=16,
                           dtype=torch.float32)
    state, tenants = mw.decode_state(cfg, kv)
    step = ss.make_decode_step(cfg, kv, tenants)
    logits, tokens = [], []
    for _ in range(mw.STEPS):
        state, lg, _ = step(params, state)
        logits.append(lg)
        tokens.append(state.tokens)
    g_logits, g_tokens, g_pool, g_tables = got["deepseek-7b", "decode"]
    assert (g_logits - torch.stack(logits)).abs().max() <= 1e-5
    assert torch.equal(g_tokens, torch.stack(tokens))
    assert torch.equal(g_tables, state.paged.block_tables)
    assert (g_pool - state.paged.k_pages).abs().max() <= 1e-5


def test_sharded_prefill_matches_unsharded(mesh_run):
    got, trees, _ = mesh_run
    cfg, params = _port_params(trees, "deepseek-7b")
    res = ss.make_family_prefill(cfg)(params, mw.prefill_batch(cfg))
    g_last, g_k = got["deepseek-7b", "prefill"]
    assert (g_last - res.last_logits).abs().max() <= 1e-5
    assert torch.equal(g_last.argmax(-1), res.last_logits.argmax(-1))
    assert (g_k - res.kv[0]).abs().max() <= 1e-5


def test_sharded_moe_prefill_matches_jax_groups(mesh_run):
    """On the 2x2 mesh the MoE dispatches in G = |data| = 2 groups, with
    drops; JAX's forward at G = 2 gives the same logits."""
    got, trees, cfgs = mesh_run
    cfg = smoke_config("mixtral-8x7b")
    batch = mw.prefill_batch(cfg)
    with j_use_hints(GroupHints(2)):
        full = np.asarray(j_forward(trees["mixtral-8x7b"],
                                    cfgs["mixtral-8x7b"],
                                    jnp.asarray(batch["tokens"].numpy())))
    last = batch["lengths"].long() - 1
    want = full[np.arange(mw.LANES), last.numpy()]
    g_last, _ = got["mixtral-8x7b", "prefill"]
    assert np.abs(g_last.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    # at G = 1 the drops differ: the groups are what the mesh changed
    with j_use_hints(GroupHints(1)):
        one = np.asarray(j_forward(trees["mixtral-8x7b"],
                                   cfgs["mixtral-8x7b"],
                                   jnp.asarray(batch["tokens"].numpy())))
    assert np.abs(one[np.arange(mw.LANES), last.numpy()] - want).max() > 1e-3


def test_one_rank_mesh_serves_the_unsharded_tokens():
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_smoke_mesh, process_group
    from repro_torch.launch.serve import serve_loop, synth_requests
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.scheduler import Scheduler, make_scheduler_config
    cfg = smoke_config("deepseek-7b")

    def serve(mesh=None):
        params = init_params(cfg, 0, torch.float32, "cpu")
        if mesh is not None:
            sh.distribute_params(cfg, mesh, params)
        kv = make_paged_config(cfg, seq_len=128, lanes=4, page_size=16,
                               dtype=torch.float32)
        scfg = make_scheduler_config(cfg, kv, max_prompt_len=64)
        eng = ServingEngine(cfg, kv, params, sched_cfg=scfg, device="cpu",
                            hints=None if mesh is None
                            else ShardingHints(mesh))
        reqs = synth_requests(cfg, 6, np.random.RandomState(0))
        serve_loop(eng, Scheduler(scfg), reqs, 8)
        return [list(r.output) for r in reqs], eng.stats

    want, s0 = serve()
    with tempfile.TemporaryDirectory() as d:
        import torch.distributed as dist
        with process_group("gloo", 1, 0, dist.FileStore(f"{d}/s", 1)):
            got, s1 = serve(make_host_smoke_mesh("cpu"))
    assert got == want
    assert (s1.commits, s1.decode_steps, s1.prefill_passes) == \
        (s0.commits, s0.decode_steps, s0.prefill_passes)


def test_kernel_route_takes_whole_operands_only():
    """A kernel wrapper's ``DTensor`` route runs its kernel over the local
    tensors when each operand is whole on the rank (a one-rank mesh) and
    raises for a sharded one: it never swaps in the plain version."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import process_group
    from torch.distributed.device_mesh import init_device_mesh
    x = torch.arange(8.0).reshape(4, 2)
    with process_group("fake", 1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        d = sh.distribute(x, mesh, ("data", None))
        out = sh.whole_on_rank(lambda t: t * 2, d, d)
        assert torch.equal(out.to_local(), x * 2)
        assert tuple(out.placements) == tuple(d.placements)
    with process_group("fake", 4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        d = sh.distribute(x.to("meta"), mesh, ("data", None))
        with pytest.raises(NotImplementedError, match="whole on the rank"):
            sh.whole_on_rank(lambda t: t * 2, d, d)


def test_constrain_moves_a_dtensor_and_leaves_the_rest():
    """``constrain`` (JAX's ``with_sharding_constraint``) redistributes a
    ``DTensor`` to the spec and degrades gracefully: a plain tensor, no
    mesh, or an axis the mesh lacks gives the input back."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import process_group
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    x = torch.empty(8, 4, device="meta")
    with process_group("fake", 4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        d = sh.distribute(x, mesh, (None, None))
        moved = sh.constrain(d, mesh, ("data", "model"))
        assert tuple(moved.placements) == (Shard(0), Shard(1))
        assert sh.constrain(d, mesh, ("pod", None)) is d
        assert sh.constrain(x, mesh, ("data", None)) is x
        assert sh.constrain(d, None, ("data", None)) is d
        assert tuple(sh.constrain(moved, mesh, (None, None)).placements) \
            == (Replicate(), Replicate())
