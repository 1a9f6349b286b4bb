"""One rank of ``tests/test_torch_hints.py``'s 2x2 CPU mesh (a gloo group
of 4 processes): it runs the port's sharded steps and rank 0 saves their
whole outputs for the test to compare.  No JAX here: the weights come in
as numpy arrays."""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import smoke_config
from repro_torch.core.paged_kv import paged_tenants
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.hints import ShardingHints
from repro_torch.launch.mesh import process_group
from repro_torch.models import make_paged_config, params_from_numpy
from repro_torch.serve import serve_step as ss
from torch.distributed.device_mesh import init_device_mesh

LANES, PREFILLED, STEPS = 4, 20, 3


def _tree(npz) -> dict:
    """The JAX parameter tree from ``np.savez`` keys ``a/b/c``."""
    tree: dict = {}
    for key in npz.files:
        sub = tree
        *head, leaf = key.split("/")
        for k in head:
            sub = sub.setdefault(k, {})
        sub[leaf] = npz[key]
    return tree


def decode_state(cfg, kv, seed: int = 1):
    """A serving state of ``LANES`` lanes prefilled to ``PREFILLED`` tokens
    with pools of seeded values (the same on every rank)."""
    tenants = paged_tenants(kv, "cpu")
    state = ss.init_serve_state(cfg, kv, LANES, tenants,
                                prefilled_len=PREFILLED)
    g = torch.Generator().manual_seed(seed)
    state.paged.k_pages.normal_(generator=g)
    state.paged.v_pages.normal_(generator=g)
    return state, tenants


def prefill_batch(cfg, seed: int = 2) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (LANES, 24),
                                    generator=g, dtype=torch.int32),
            "lengths": torch.tensor([24, 17, 9, 24], dtype=torch.int32)}


def run(rank: int, store_path: str, out_path: str, weights: dict) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, 4)
    out = {}
    with process_group("gloo", 4, rank, store):
        # a tuple of axes on one dim: pod-major, as JAX shards it
        pm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
        local = sh.distribute(torch.arange(8), pm, (("pod", "data"),))
        blocks = [None] * 4
        dist.all_gather_object(blocks, local.to_local().tolist())
        out["pod_major"] = blocks
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        hints = ShardingHints(mesh)
        for arch, npz in weights.items():
            cfg = smoke_config(arch)
            if arch == "mixtral-8x7b":   # pairs drop: the groups matter
                cfg = dataclasses.replace(cfg, moe_capacity_factor=1.0)
            params = params_from_numpy(_tree(np.load(npz)), cfg,
                                       dtype=torch.float32, device="cpu")
            sh.distribute_params(cfg, mesh, params)
            res = ss.make_family_prefill(cfg, hints=hints)(
                params, sh.distribute_batch(cfg, mesh, prefill_batch(cfg)))
            out[arch, "prefill"] = (res.last_logits.full_tensor(),
                                    res.kv[0].full_tensor())
            if arch != "deepseek-7b":
                continue
            kv = make_paged_config(cfg, 64, LANES, page_size=16,
                                   dtype=torch.float32)
            state, tenants = decode_state(cfg, kv)
            state = sh.distribute_state(cfg, mesh, state)
            step = ss.make_decode_step(cfg, kv, tenants, hints=hints)
            logits, tokens = [], []
            for _ in range(STEPS):
                state, lg, _ = step(params, state)
                logits.append(lg.full_tensor())
                tokens.append(state.tokens.full_tensor())
            out[arch, "decode"] = (torch.stack(logits), torch.stack(tokens),
                                   state.paged.k_pages.full_tensor(),
                                   state.paged.block_tables.full_tensor())
    if rank == 0:
        torch.save(out, out_path)
