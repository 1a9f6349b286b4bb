"""Sharding rules: a spec for every parameter, batch and serving-state
tensor on the production mesh (port of :mod:`repro.distributed.sharding`,
same rules).

Strategy (the JAX package's DESIGN.md §5):
  * TP over ``model``: attention heads, MLP hidden, vocab, MoE experts
    (true EP when num_experts divides |model|, otherwise expert-ff TP).
  * FSDP over ``data`` (+``pod``): the contracting/input dim of each large
    matrix is additionally sharded over the data axes.  Optimizer state
    inherits the parameters' sharding.
  * Batch over (``pod``, ``data``).
  * Serving: lanes over the data axes, KV pool pages over the data axes,
    KV heads over ``model``; the allocator metadata (int32 free lists,
    block tables) is tiny and *replicated*: every rank runs the same
    support-core burst, "one owner, zero synchronization".

Divisibility-aware: a rule that does not divide falls back to replication
for that dim.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name,
or a tuple of axis names -- the data of a JAX ``PartitionSpec``.
:func:`to_placements` turns it into ``DTensor`` placements, one per mesh
dim; a tuple of axes on one dim shards in mesh order (pod-major), as JAX
does.  A mesh here is a :class:`~torch.distributed.device_mesh.DeviceMesh`
or a plain ``{axis: size}`` dict (the specs need only the sizes).

The port keeps one module per layer where the JAX tree stacks the layers
along a leading L dim: a per-layer leaf's spec is the JAX leaf's without
that leading ``None``; leaves are named through
:func:`repro_torch.models.model_zoo.jax_path`.

**The KV pools' sink page.**  The port's pools are ``[num_pages + 1, L,
ps, KV, hd]``: page ``num_pages`` is a write sink for masked lanes
(:mod:`repro_torch.core.paged_kv`); the JAX pools have ``num_pages`` rows.
The rules are evaluated on the page count without the sink, so the port's
spec for ``k_pages``/``v_pages`` is JAX's on every mesh, and the sink
rides in the last rank's shard of the page dim: ``DTensor`` splits the
``num_pages + 1`` rows as ``torch.chunk`` does, so a rank holds at most
one page more than under JAX.  :func:`pool_write` writes the decode's new
K/V into such a shard without a local sink.

:func:`distribute_params` and :func:`distribute_state` place a port tree
on a mesh from values that every rank holds whole (seeded alike, or
``meta``): each rank keeps its own shard, with no communication.  The
allocator runs on replicated metadata as local tensors
(:func:`local_replicated`), the port's counterpart of the JAX package's
replicated ``jnp`` support core.
"""
from __future__ import annotations

import functools
from typing import Callable, Mapping

import torch

from ..configs.base import ArchConfig

Spec = tuple


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of such a dict."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fits(dim: int, mesh, axes) -> bool:
    return axes is not None and dim % _axis_size(mesh, axes) == 0


def _spec(mesh, shape: tuple, wants: list) -> Spec:
    """A spec with the axes that do not divide their dim dropped."""
    return tuple(want if _fits(dim, mesh, want) else None
                 for dim, want in zip(shape, wants))


def dp_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh_sizes(mesh))
    return axes if axes else None


# --------------------------------------------------------------------------
# Parameter sharding
# --------------------------------------------------------------------------

def param_spec(mesh, name: str, shape: tuple) -> Spec:
    """The spec of the parameter ``name`` (a port name, ``layers.3.wq``)
    of ``shape``: the JAX rule for its leaf, per layer."""
    from ..models.model_zoo import jax_path
    path, _ = jax_path(name)
    leaf = path[-1]
    dp = dp_axes(mesh)
    nd = len(shape)

    def w(*wants):
        return _spec(mesh, shape, list(wants))

    if leaf == "embed":
        return w("model", dp)
    if leaf == "unembed":
        return w(dp, "model")
    if leaf in ("wq", "wk", "wv", "wg", "decay_lora_a"):
        return w(dp, "model") if nd == 2 else w("model")
    if leaf in ("bq", "bk", "bv"):
        return w("model")
    if leaf in ("wo", "decay_lora_b"):
        return w("model", dp)
    if leaf == "w_in":
        if nd == 3:   # MoE [E, d, ff*]
            if _fits(shape[0], mesh, "model"):
                return w("model", dp, None)       # EP
            return w(None, dp, "model")           # TP-MoE
        return w(dp, "model")
    if leaf == "w_out":
        if nd == 3:   # MoE [E, ff, d]
            if _fits(shape[0], mesh, "model"):
                return w("model", None, dp)
            return w(None, "model", dp)
        return w("model", dp)
    if leaf == "router":
        return w(dp, None)
    if leaf == "in_proj":    # mamba: mixed-segment projection -> fsdp only
        return w(dp, None)
    if leaf == "out_proj":
        return w(None, dp)
    if leaf in ("enc_pos", "dec_pos"):
        return w(None, dp)
    # norms, biases, conv weights, decay bases, mixing params: replicate
    return (None,) * nd


def param_specs(cfg: ArchConfig, mesh, params) -> dict[str, Spec]:
    """``{name: spec}`` for every parameter of the family's LM (real or
    ``meta``)."""
    return {n: param_spec(mesh, n, tuple(p.shape))
            for n, p in params.named_parameters()}


def batch_specs(cfg: ArchConfig, mesh, batch: Mapping) -> dict[str, Spec]:
    """Every batch input: the leading (batch) dim over the data axes."""
    dp = dp_axes(mesh)
    return {k: _spec(mesh, tuple(x.shape), [dp] + [None] * (x.ndim - 1))
            for k, x in batch.items()}


# --------------------------------------------------------------------------
# Serving-state sharding
# --------------------------------------------------------------------------

def state_leaf_spec(mesh, name: str, shape: tuple,
                    pool_layout: str = "pages") -> Spec:
    """The spec of a serving-state leaf by its field name (JAX's rule).
    ``pool_layout`` is the JAX package's ``REPRO_POOL_LAYOUT`` as an
    argument (``pages`` | ``layers`` | ``pages_hd``)."""
    dp = dp_axes(mesh)
    if name in ("k_pages", "v_pages"):
        # [num_pages + 1, L, ps, kv_heads, head_dim]: the rules see the
        # pages without the sink (module docstring)
        shape = (shape[0] - 1,) + tuple(shape[1:])
        if pool_layout == "pages_hd":
            return _spec(mesh, shape, [dp, None, None, None, "model"])
        if pool_layout == "layers" and _fits(shape[1], mesh, dp):
            if _fits(shape[3], mesh, "model"):
                return _spec(mesh, shape, [None, dp, None, "model", None])
            return _spec(mesh, shape, [None, dp, None, None, "model"])
        if _fits(shape[3], mesh, "model"):
            return _spec(mesh, shape, [dp, None, None, "model", None])
        pages_axes = tuple(dp) + ("model",) if dp else "model"
        return _spec(mesh, shape, [pages_axes, None, None, None, None])
    if name == "ssm":      # [L, B, h, dk, dv]
        return _spec(mesh, shape, [None, dp, "model", None, None])
    if name in ("conv", "tm_prev", "cm_prev"):  # [L, B, ...]
        return _spec(mesh, shape, [None, dp, None, None])
    if name == "enc_out":  # [B, F, d]
        return _spec(mesh, shape, [dp, None, None])
    if name == "tokens":
        return _spec(mesh, shape, [dp])
    # allocator and lane metadata, counters: replicated, tiny
    return (None,) * len(shape)


def _leaves(tree, prefix: tuple = ()):
    """``(path of field names, tensor)`` of every tensor leaf of nested
    NamedTuples (``None`` fields skipped)."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            if v is not None:
                yield from _leaves(v, prefix + (f,))


def serve_state_specs(cfg: ArchConfig, mesh, state,
                      pool_layout: str = "pages") -> dict[tuple, Spec]:
    """``{path: spec}`` for every tensor leaf of a
    :class:`~repro_torch.serve.serve_step.ServeState` (lanes and pages
    over the data axes, KV heads over ``model`` when they divide,
    allocator metadata replicated)."""
    return {path: state_leaf_spec(mesh, path[-1], tuple(t.shape),
                                  pool_layout)
            for path, t in _leaves(state)}


def shard_bytes(shape: tuple, itemsize: int, mesh, spec: Spec) -> int:
    """Bytes of the largest shard of a ``shape`` tensor under ``spec``
    (``torch.chunk``'s split: ceil on each sharded dim)."""
    n = itemsize
    for dim, axes in zip(shape, spec):
        k = _axis_size(mesh, axes)
        n *= -(-dim // k)
    return n


# --------------------------------------------------------------------------
# DTensor placement
# --------------------------------------------------------------------------

def to_placements(mesh, spec: Spec) -> list:
    """``DTensor`` placements (one per mesh dim) of ``spec``: ``Shard(d)``
    on each mesh dim named in entry ``d``, ``Replicate()`` on the others.
    The axes of one entry must come in mesh order (pod-major)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, want in enumerate(spec):
        if want is None:
            continue
        axes = (want,) if isinstance(want, str) else tuple(want)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {want} is not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def constrain(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """``x`` redistributed to ``spec`` on ``mesh`` (JAX's
    ``with_sharding_constraint``), degrading gracefully: a plain tensor,
    no mesh, or a spec that names an axis the mesh lacks gives ``x``."""
    if mesh is None or not is_dtensor(x):
        return x
    try:
        placements = to_placements(mesh, spec)
    except ValueError:
        return x
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """``t`` (whole on every rank, or ``meta``) as a ``DTensor`` under
    ``spec``: each rank keeps its own shard, no communication."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    placements = to_placements(mesh, spec)
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, placements)
    local = t
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != t.shape[d]:
            local = local.narrow(d, o, n)
    # a shard owns its storage (a narrowed view would keep the whole
    # value alive); a whole one is the value itself, shared in place
    local = local.clone(memory_format=torch.contiguous_format) \
        if local is not t else t.contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_params(cfg: ArchConfig, mesh, params):
    """Place every parameter of the LM ``params`` on ``mesh`` by
    :func:`param_spec` (in place; returns the module)."""
    for name, p in list(params.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        setattr(mod, leaf, torch.nn.Parameter(
            distribute(p.detach(), mesh, param_spec(mesh, name,
                                                    tuple(p.shape))),
            requires_grad=p.requires_grad))
    return params


def _rebuild(tree, fn: Callable, prefix: tuple = ()):
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[None if v is None else _rebuild(v, fn,
                                                            prefix + (f,))
                            for f, v in zip(tree._fields, tree)])
    return tree


def distribute_state(cfg: ArchConfig, mesh, state,
                     pool_layout: str = "pages"):
    """A serving state (any NamedTuple tree of tensors) placed on
    ``mesh`` by :func:`state_leaf_spec`."""
    return _rebuild(state, lambda path, t: distribute(
        t, mesh, state_leaf_spec(mesh, path[-1], tuple(t.shape),
                                 pool_layout)))


def distribute_batch(cfg: ArchConfig, mesh, batch: Mapping) -> dict:
    """A batch dict placed on ``mesh`` by :func:`batch_specs`."""
    specs = batch_specs(cfg, mesh, batch)
    return {k: distribute(x, mesh, specs[k]) for k, x in batch.items()}


def local_tree(tree):
    """``tree`` with every ``DTensor`` leaf (nested NamedTuples, tuples,
    lists and dicts) replaced by its local shard."""
    return _map_tensors(tree, lambda t: t.to_local() if is_dtensor(t)
                        else t)


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    if not torch.distributed.is_available():
        return ()
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, torch.Tensor) and isinstance(x, _dtensor_type())


def find_mesh(tree):
    """The mesh of the first ``DTensor`` in ``tree`` (nested tuples,
    lists, dicts), else ``None``."""
    if is_dtensor(tree):
        return tree.device_mesh
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            m = find_mesh(v)
            if m is not None:
                return m
    return None


def _map_tensors(tree, fn: Callable):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tensors(v, fn) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return tree


def local_replicated(fn: Callable) -> Callable:
    """``fn`` run on every rank over whole local tensors: each ``DTensor``
    argument is made replicated (a collective where it is sharded) and
    passed as its local tensor; every tensor ``fn`` returns comes back as a
    replicated ``DTensor``.  Without a ``DTensor`` argument it is ``fn``.
    The allocator's metadata is replicated by rule, so its bursts run
    this way: the same deterministic support-core step on every rank."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        mesh = find_mesh((args, kwargs))
        if mesh is None:
            return fn(*args, **kwargs)
        from torch.distributed.tensor import DTensor, Replicate
        rep = [Replicate()] * mesh.ndim

        def unwrap(t):
            if not is_dtensor(t):
                return t
            if any(not p.is_replicate() for p in t.placements):
                t = t.redistribute(t.device_mesh, rep)
            return t.to_local()

        out = fn(*_map_tensors(args, unwrap),
                 **_map_tensors(kwargs, unwrap))
        return _map_tensors(out, lambda t: DTensor.from_local(
            t, mesh, rep, run_check=False))
    return wrapped


def shard_map(fn: Callable, mesh, in_specs: tuple, out_spec) -> Callable:
    """``fn`` run on each rank over its shards (JAX's ``shard_map``): each
    tensor argument is placed by its spec in ``in_specs`` (``None`` for a
    non-tensor) and passed as its local tensor; each tensor ``fn`` returns
    (one, or a tuple) is placed by ``out_spec``, or by its own entry where
    ``out_spec`` is a list of specs.  A plain tensor argument
    is taken as whole on every rank.  The caller picks specs under which
    ``fn`` on the shards is the function on the whole (rows that are
    independent of each other)."""
    from torch.distributed.tensor import DTensor

    def local(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        if not is_dtensor(t):
            t = distribute(t, mesh, (None,) * t.ndim)
        return t.redistribute(mesh, to_placements(mesh, spec)).to_local()

    @functools.wraps(fn)
    def wrapped(*args):
        out = fn(*[local(a, sp) for a, sp in zip(args, in_specs)])
        if isinstance(out_spec, list):
            return tuple(DTensor.from_local(o, mesh, to_placements(mesh, sp),
                                            run_check=False)
                         for o, sp in zip(out, out_spec))
        placements = to_placements(mesh, out_spec)
        return _map_tensors(out, lambda t: DTensor.from_local(
            t, mesh, placements, run_check=False))
    return wrapped


def group_local(fn: Callable, groups: int) -> Callable:
    """``fn`` over tensors whose dim 0 is ``groups`` dispatch groups, run
    on each rank over its own groups (:func:`shard_map` with every
    argument and output placed groups-over-the-data-axes).  Where the
    groups do not split evenly over the data axes it is
    :func:`local_replicated`; without a mesh it is ``fn``."""
    @functools.wraps(fn)
    def wrapped(*args):
        mesh = find_mesh(args)
        if mesh is None:
            return fn(*args)
        dp = dp_axes(mesh)
        if not dp or groups % _axis_size(mesh, dp):
            return local_replicated(fn)(*args)
        specs = tuple((dp,) if isinstance(a, torch.Tensor) else None
                      for a in args)
        return shard_map(fn, mesh, specs, (dp,))(*args)
    return wrapped


def attention_axes(mesh, lanes: int, kv_heads: int):
    """``(lane axes, head axis)`` an attention runs over on ``mesh``: the
    data axes for the lanes (sequences) and ``model`` for the heads, each
    where it divides (else ``None``: whole on every rank).  A KV head and
    its group of query heads stay on one rank."""
    dp = dp_axes(mesh)
    if dp and lanes % _axis_size(mesh, dp):
        dp = None
    sizes = mesh_sizes(mesh)
    m = "model" if "model" in sizes and kv_heads % sizes["model"] == 0 \
        else None
    return dp, m


def heads_local(fn: Callable, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Attention ``fn(q, k, v)`` over ``[B, T, H|KV, hd]`` run on each rank
    over its lanes and heads (:func:`attention_axes`): every sequence and
    every KV head's group of query heads is independent.  Without a
    ``DTensor`` it is ``fn``."""
    mesh = find_mesh((q, k, v))
    if mesh is None:
        return fn(q, k, v)
    dp, m = attention_axes(mesh, q.shape[0], k.shape[2])
    spec = (dp, None, m, None)
    return shard_map(fn, mesh, (spec,) * 3, spec)(q, k, v)


def whole_on_rank(fn: Callable, out_like: torch.Tensor, *args, **kwargs):
    """A kernel wrapper's route for ``DTensor`` operands on the card:
    ``fn`` over their local tensors when every one is whole on the rank
    (its local shape is its global shape: a one-rank mesh, or replicated),
    the result placed as ``out_like``.  Otherwise it raises: a kernel
    reads whole operands, and the plain version is never swapped in."""
    from torch.distributed.tensor import DTensor

    def unwrap(t):
        if not is_dtensor(t):
            return t
        if tuple(t.to_local().shape) != tuple(t.shape):
            raise NotImplementedError(
                f"a kernel operand of shape {tuple(t.shape)} is sharded "
                f"{t.placements} over {t.device_mesh}: the kernel route "
                f"takes operands whole on the rank (a one-rank mesh)")
        return t.to_local()

    out = fn(*_map_tensors(args, unwrap), **_map_tensors(kwargs, unwrap))
    return DTensor.from_local(out, out_like.device_mesh, out_like.placements,
                              run_check=False)


def pool_write(pool: torch.Tensor, pages: torch.Tensor, offset: torch.Tensor,
               new: torch.Tensor) -> None:
    """``pool[pages, :, offset] = new`` in place (``pool [P, L, ps, KV,
    hd]``, ``pages``/``offset`` ``[B]``, ``new [B, L, KV, hd]``).

    A plain pool (or one whole on the rank) takes the write as it is.  A
    pool sharded on its page dim has no sink page in most shards, so each
    rank writes the rows whose page it holds and leaves the others: the
    write adds each row's bit difference to the slot it reads, as integers
    with ``accumulate`` (masked rows add zero, and a clamped slot shared by
    masked rows is left as it was), which is exact.  Other dims shard as
    the pool does; the rows and indices are made whole on every rank."""
    if not is_dtensor(pool):
        pool[pages, :, offset] = new.to(pool.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = pool.device_mesh
    local = pool.to_local()
    if tuple(local.shape) == tuple(pool.shape):
        pool_write(local, _whole(pages, mesh), _whole(offset, mesh),
                   _whole(new, mesh).to(pool.dtype))
        return
    # new [B, L, KV, hd]: pool dims 1, 3, 4 -> new dims 1, 2, 3
    want = [Shard({1: 1, 3: 2, 4: 3}[p.dim])
            if isinstance(p, Shard) and p.dim in (1, 3, 4) else Replicate()
            for p in pool.placements]
    new_l = (new if is_dtensor(new) else DTensor.from_local(
        new, mesh, [Replicate()] * mesh.ndim, run_check=False)
             ).redistribute(mesh, want).to_local().to(pool.dtype)
    shape, off = compute_local_shape_and_global_offset(
        pool.shape, mesh, pool.placements)
    lo, n = off[0], shape[0]
    pages, offset = _whole(pages, mesh).long(), _whole(offset, mesh).long()
    mine = (pages >= lo) & (pages < lo + n)
    rows = torch.where(mine, pages - lo, 0)
    bits = {2: torch.int16, 4: torch.int32}[local.element_size()]
    lb = local.view(bits)
    cur = lb[rows, :, offset]                       # [B, L, KV, hd]
    delta = torch.where(mine[:, None, None, None],
                        new_l.view(bits) - cur, 0).to(bits)
    lidx = torch.arange(lb.shape[1], device=lb.device)
    lb.index_put_((rows[:, None], lidx[None, :], offset[:, None]), delta,
                  accumulate=True)


def fit_split(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``t`` ready for a reshape that splits dim ``dim`` into ``parts``
    leading pieces: the mesh dims that shard it keep it sharded while
    their product divides ``parts``, in mesh order, and make it whole
    after (a plain tensor as it is)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    dim %= t.ndim
    mesh = t.device_mesh
    want, n = [], 1
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            if parts % (n * mesh.size(i)):
                p = Replicate()
            else:
                n *= mesh.size(i)
        want.append(p)
    if want == list(t.placements):
        return t
    return t.redistribute(mesh, want)


class _FitGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, parts):
        ctx.dim, ctx.parts = dim, parts
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return fit_split(g, ctx.dim, ctx.parts), None, None


def grad_fit(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``t``, whose gradient is made ready (:func:`fit_split`) for the
    backward of the reshape that merged dim ``dim`` from ``parts`` leading
    pieces (a plain tensor, or one without a gradient, as it is)."""
    if not is_dtensor(t) or not t.requires_grad:
        return t
    return _FitGrad.apply(t, dim, parts)


def flat_ready(x: torch.Tensor) -> torch.Tensor:
    """An activation ``[B, ..., d]`` ready for a product that flattens its
    leading dims: sharded on ``B`` at most (its inner dims made whole, as
    Megatron's sequence parallelism gathers the sequence ahead of the
    column-parallel products).  A plain tensor as it is."""
    if not is_dtensor(x) or x.ndim < 3:
        return x
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1 else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _FlatGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return flat_ready(g)


def grad_flat(y: torch.Tensor) -> torch.Tensor:
    """``y``, whose gradient is made :func:`flat_ready` (for the backward
    of a reshape that merges ``y``'s leading dims; a plain tensor, or
    one without a gradient, as it is)."""
    if not is_dtensor(y) or not y.requires_grad:
        return y
    return _FlatGrad.apply(y)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """``embed[tokens]`` (``embed [V, d]``).  On a mesh each rank looks
    its token ids up in its own rows of the vocabulary, zeros for ids it
    does not hold, and the rows are summed over the mesh dims that split
    the vocabulary (GSPMD's masked gather and all-reduce; no rank gathers
    the table); they come out sharded as ``embed``'s ``d``."""
    if not is_dtensor(embed):
        return embed[tokens.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = embed.device_mesh
    shape, off = compute_local_shape_and_global_offset(
        embed.shape, mesh, embed.placements)
    ids = _whole(tokens, mesh).long() - off[0]
    mine = (ids >= 0) & (ids < shape[0])
    local = embed.to_local()
    rows = torch.where(mine[..., None], local[ids.clamp(0, shape[0] - 1)],
                       torch.zeros((), dtype=local.dtype,
                                   device=local.device))
    partial = [Partial() if p.is_shard(0) else
               Shard(rows.ndim - 1) if p.is_shard(1) else Replicate()
               for p in embed.placements]
    return DTensor.from_local(rows, mesh, partial, run_check=False) \
        .redistribute(mesh, [Replicate() if p.is_partial() else p
                             for p in partial])


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for an activation ``x [B, ..., d_in]``: on a mesh ``x`` and
    the product's gradient are :func:`flat_ready` (a sharded inner dim
    would flatten into a strided placement); a plain ``x @ w``
    otherwise."""
    if not is_dtensor(x):
        return x @ w
    y = flat_ready(x) @ w
    return _FlatGrad.apply(y) if y.requires_grad and y.ndim > 2 else y


def replicated(t: torch.Tensor) -> torch.Tensor:
    """``t`` replicated on its mesh (a plain tensor as it is)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _whole(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole value of ``t`` on this rank (a plain tensor as it is)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
