"""The port's sharding rules (``repro_torch.distributed.sharding``), its
config helpers and roofline terms against the JAX package's, on the
production mesh shapes without devices (JAX's ``AbstractMesh``; the port
needs only the axis sizes).

* Every parameter, batch and serving-state leaf of all ten archs gets
  JAX's spec on (16, 16) and (2, 16, 16), under each pool layout (the JAX
  side reads ``REPRO_POOL_LAYOUT`` on every call).  JAX stacks the layers
  of a stack along a leading dim, replicated; a port leaf is one layer's,
  named through ``jax_path``.  The KV pools carry the port's sink page,
  and their spec is JAX's all the same.
* Per-device parameter bytes equal JAX's, summed from each side's specs.
* ``param_count``, ``active_param_count`` and ``model_flops`` equal JAX's;
  ``collective_bytes`` equals ``parse_collective_bytes`` on HLO lines of
  each collective.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import abstract_params as j_abstract_params  # noqa: E402
from repro.models import input_specs as j_input_specs  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.serve.serve_step import \
    abstract_serve_state as j_abstract_serve_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from _port_only import SHARED_ARCH_IDS as ARCH_IDS  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.models import abstract_params, input_specs  # noqa: E402
from repro_torch.models import make_paged_config  # noqa: E402
from repro_torch.models.model_zoo import jax_path  # noqa: E402
from repro_torch.serve.serve_step import abstract_serve_state  # noqa: E402

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LAYOUTS = ("pages", "layers", "pages_hd")
#: serving-state leaves the JAX state has and the port's does not
JAX_ONLY = {("paged", "lane_state"), ("step",)}


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), dict(zip(names, shape))


def _norm(spec) -> tuple:
    """A spec's entries with one-axis tuples as the axis name."""
    out = []
    for e in spec:
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def _j_leaves(tree, specs) -> dict:
    """``{path of names: (shape, spec, itemsize)}`` of a JAX tree and its
    specs."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(_key(k) for k in path):
            (tuple(leaf.shape), spec, leaf.dtype.itemsize)
            for (path, leaf), spec in zip(leaves, spec_leaves)}


@pytest.fixture(scope="module")
def j_params():
    return {a: j_abstract_params(j_get_config(a)) for a in ARCH_IDS}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, mesh_name, j_params):
    jmesh, mesh = _meshes(mesh_name)
    jtree = j_params[arch]
    jl = _j_leaves(jtree, jsh.param_specs(j_get_config(arch), jmesh, jtree))
    params = abstract_params(get_config(arch))
    specs = sh.param_specs(get_config(arch), mesh, params)
    seen = set()
    for name, p in params.named_parameters():
        path, idx = jax_path(name)
        shape, jspec, _ = jl[path]
        jspec = _norm(jspec)
        if idx is not None:        # JAX's stacked leaf: [L, ...]
            assert jspec[0] is None and shape[1:] == tuple(p.shape), name
            jspec = jspec[1:]
        assert _norm(specs[name]) == jspec, (name, specs[name], jspec)
        seen.add(path)
    assert seen == set(jl)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_bytes_per_device_match_jax(mesh_name, j_params):
    """Each rank's parameter bytes (the largest shard of every leaf,
    summed) equal JAX's; divisibility holds, so every rank holds as
    much."""
    jmesh, mesh = _meshes(mesh_name)
    for arch in ARCH_IDS:
        jtree = j_params[arch]
        jl = _j_leaves(jtree, jsh.param_specs(j_get_config(arch), jmesh,
                                              jtree))
        want = sum(sh.shard_bytes(shape, size, mesh, spec)
                   for shape, spec, size in jl.values())
        params = abstract_params(get_config(arch))
        specs = sh.param_specs(get_config(arch), mesh, params)
        got = sum(sh.shard_bytes(tuple(p.shape), p.element_size(), mesh,
                                 specs[n])
                  for n, p in params.named_parameters())
        assert got == want, arch


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_divide_and_big_params_are_sharded(mesh_name):
    _, mesh = _meshes(mesh_name)
    for arch in ARCH_IDS:
        params = abstract_params(get_config(arch))
        for name, spec in sh.param_specs(get_config(arch), mesh,
                                         params).items():
            shape = params.get_parameter(name).shape
            for dim, want in zip(shape, spec):
                assert want is None or dim % sh._axis_size(mesh, want) == 0
    params = abstract_params(get_config("qwen2-72b"))
    specs = sh.param_specs(get_config("qwen2-72b"), mesh, params)
    worst = max(sh.shard_bytes(tuple(p.shape), p.element_size(), mesh,
                               specs[n]) for n, p in params.named_parameters())
    assert worst < 1 << 30


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_match_jax(mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if SHAPES[shape]["kind"] == "decode":
                continue
            jb = j_input_specs(j_get_config(arch), shape)
            tb = input_specs(get_config(arch), shape)
            assert set(jb) == set(tb)
            jspecs = jsh.batch_specs(j_get_config(arch), jmesh, jb)
            tspecs = sh.batch_specs(get_config(arch), mesh, tb)
            for k in jb:
                assert tuple(tb[k].shape) == tuple(jb[k].shape)
                assert _norm(tspecs[k]) == _norm(jspecs[k]), (arch, k)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_serve_state_specs_match_jax(mesh_name, layout, monkeypatch):
    """decode_32k's serving state of every arch: each leaf's spec is
    JAX's, the pools' too (the port's have one page more)."""
    monkeypatch.setenv("REPRO_POOL_LAYOUT", layout)
    jmesh, mesh = _meshes(mesh_name)
    shp = SHAPES["decode_32k"]
    lanes, seq = shp["global_batch"], shp["seq_len"]
    for arch in ARCH_IDS:
        jcfg, cfg = j_get_config(arch), get_config(arch)
        jkv = j_make_paged_config(jcfg, seq_len=seq, lanes=lanes)
        kv = make_paged_config(cfg, seq_len=seq, lanes=lanes)
        assert kv.num_pages == jkv.num_pages
        jstate = j_abstract_serve_state(jcfg, jkv, lanes, prefilled_len=seq)
        jl = _j_leaves(jstate, jsh.serve_state_specs(jcfg, jmesh, jstate))
        state, _ = abstract_serve_state(cfg, kv, lanes, seq)
        specs = sh.serve_state_specs(cfg, mesh, state, pool_layout=layout)
        for path, spec in specs.items():
            jshape, jspec, _ = jl[path]
            if path[-1] in ("k_pages", "v_pages"):
                assert jshape[0] + 1 == state.paged.k_pages.shape[0]
            assert _norm(spec) == _norm(jspec), (arch, path, spec, jspec)
        assert set(jl) - set(specs) <= JAX_ONLY, arch


def test_dp_axes_match_jax():
    for name in MESHES:
        jmesh, mesh = _meshes(name)
        assert sh.dp_axes(mesh) == jsh.dp_axes(jmesh)


def test_param_counts_and_model_flops_match_jax():
    for arch in ARCH_IDS:
        c, jc = get_config(arch), j_get_config(arch)
        assert c.param_count() == jc.param_count()
        assert c.active_param_count() == jc.active_param_count()
        assert (c.is_attention_free, c.is_subquadratic) == \
            (jc.is_attention_free, jc.is_subquadratic)
        for shape in SHAPES:
            assert roofline.model_flops(arch, shape) == \
                jroof.model_flops(arch, shape), (arch, shape)


def _j_parse():
    """JAX's ``parse_collective_bytes``.  Its module sets ``XLA_FLAGS`` for
    its own process when imported; the variable is put back at once, so
    this process's JAX backend is untouched."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import parse_collective_bytes
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return parse_collective_bytes


@pytest.mark.parametrize("group", [1, 16, 256])
def test_collective_bytes_match_jax(group):
    parse = _j_parse()
    ids = ",".join(str(i) for i in range(group))
    lines = {
        "all-gather": "%ag = bf16[16,1024]{1,0} all-gather(bf16[1,1024] %x)",
        "reduce-scatter": "%rs = f32[8,128]{1,0} reduce-scatter(f32[8,2048]"
                          " %x), to_apply=%add",
        "all-reduce": "%ar = f32[4096]{0} all-reduce(f32[4096] %x), "
                      "to_apply=%add",
        "all-to-all": "%a2a = bf16[32,64,8]{2,1,0} all-to-all(bf16[32,64,8]"
                      " %x), dimensions={0}",
        "collective-permute": "%cp = s32[128]{0} collective-permute(s32[128]"
                              " %x), source_target_pairs={{0,1}}",
    }
    for op, line in lines.items():
        want = parse(f"{line}, replica_groups={{{{{ids}}}}}")[op]
        res = dryrun._bytes([torch.empty(
            [int(n) for n in line.split("[")[1].split("]")[0].split(",")],
            dtype={"bf16": torch.bfloat16, "f32": torch.float32,
                   "s32": torch.int32}[line.split("= ")[1].split("[")[0]],
            device="meta")])
        operand, wire = dryrun.collective_bytes(op, res, group)
        assert (want["count"], want["operand_bytes"], want["wire_bytes"]) \
            == (1, operand, wire), (op, group)
