"""Multi-device dry run (port of :mod:`repro.launch.dryrun`): every (arch x
shape x mesh) cell runs its step on the production mesh without a device,
and the run yields the roofline's raw terms per device.

Each cell opens PyTorch's ``fake`` process group at 256 (16x16) or 512
(2x16x16) ranks and a ``cuda`` :class:`DeviceMesh` over it; the
parameters, optimizer state, batch or serving state are ``meta``
``DTensor`` s placed by :mod:`repro_torch.distributed.sharding`, and the
step -- the port's own ``make_train_step``, ``make_prefill_step`` or
``make_decode_step`` with :class:`ShardingHints` -- runs eagerly on rank
0's shards.  A collective is recorded, never sent.  Where the JAX dry run
proves that XLA lowers and fits a cell, this one proves that the port's
step runs on it and counts what rank 0 holds and does:

* ``argument_bytes``: the local shards of every input;
* ``output_bytes``: the local shards of every output; ``temp_peak_bytes``:
  the peak over the step of the bytes that local storages hold (each
  from the op that makes it until it is freed), less the arguments;
* ``flops``: ``torch.utils.flop_counter``'s count of every aten op on
  local tensors, below the ``DTensor`` dispatch (a ``FlopCounterMode``
  around ``DTensor`` ops counts global FLOPs);
* ``bytes_accessed``: each local aten op's operand and result bytes
  (views excluded) -- an unfused upper count, as XLA's ``bytes accessed``
  is for an unfused graph;
* ``collectives``: each collective's count, operand bytes and wire bytes
  by the ring formulas of :func:`collective_bytes`.

XLA counts a while-loop body once, so the JAX dry run compiles two
unrolled depths and extrapolates; eager PyTorch runs every layer, so the
port counts the full depth directly and has no ``_variant_cfg``,
``_layer_period`` or ``extrapolate``.

Records go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``; a
failure is recorded as data (``status: error`` with its traceback), and
the CLI exits 1 if any cell errors::

    python -m repro_torch.launch.dryrun --arch deepseek-7b --shape decode_32k --mesh pod
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs.base import ARCH_IDS, SHAPES, ArchConfig, get_config
from ..distributed import sharding as sh
from ..distributed.hints import ShardingHints
from ..models.model_zoo import abstract_params, input_specs, make_paged_config
from ..serve.serve_step import (abstract_serve_state, make_decode_step,
                                make_prefill_step)
from ..train.optimizer import AdamW, AdamWState
from ..train.train_step import make_train_step
from .mesh import make_production_mesh, process_group

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: grad-accum per arch for train_4k (the JAX dry run's)
GRAD_ACCUM = {
    "qwen2-72b": 8, "phi3-medium-14b": 4, "deepseek-7b": 4,
    "mixtral-8x7b": 8, "phi3.5-moe-42b-a6.6b": 8, "rwkv6-7b": 8,
    "phi-3-vision-4.2b": 4, "zamba2-1.2b": 4, "gemma3-1b": 2,
    "whisper-medium": 4,
}

#: decode shapes skipped for pure full-attention archs (the JAX dry run's)
LONG_SKIP = {
    "deepseek-7b": "pure full attention (O(S) KV at 500k infeasible by design)",
    "phi3-medium-14b": "pure full attention",
    "qwen2-72b": "pure full attention",
    "phi-3-vision-4.2b": "pure full attention backbone",
    "phi3.5-moe-42b-a6.6b": "pure full attention",
    "whisper-medium": "decoder ctx 448 << 500k (enc-dec)",
}

#: functional collectives -> the JAX names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def collective_bytes(op: str, result_bytes: float, group_size: int
                     ) -> tuple[float, float]:
    """``(operand_bytes, wire_bytes)`` of one collective from its result's
    bytes and its group's size (the JAX ``parse_collective_bytes``
    formulas): operand -- all-gather result/G, reduce-scatter result*G,
    others the result; wire (ring estimate of per-device link traffic) --
    all-reduce 2(G-1)/G*N, gather/scatter/all-to-all (G-1)/G*N_big,
    permute N."""
    g = max(int(group_size), 1)
    res = float(result_bytes)
    if op == "all-gather":
        return res / g, res * (g - 1) / g
    if op == "reduce-scatter":
        return res * g, res * g * (g - 1) / g
    if op == "all-reduce":
        return res, 2 * res * (g - 1) / g
    if op == "all-to-all":
        return res, res * (g - 1) / g
    if op == "collective-permute":
        return res, res
    raise ValueError(f"unknown collective {op!r}")


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


class DeviceCounter(TorchDispatchMode):
    """Counts FLOPs, bytes accessed and collectives of the aten ops that
    run on local tensors, and the peak of the bytes their storages hold.
    An op on ``DTensor`` s is handed back to the ``DTensor`` dispatch
    (``NotImplemented``), whose local ops and redistributions then come
    through here.  A storage counts from the op that makes it until it
    is freed (a weak reference's callback); ``track`` counts the
    arguments' storages as held from the start."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: dict[str, dict[str, float]] = {}
        self._live: dict[int, weakref.ref] = {}
        self.held = self.peak = 0

    def track(self, tensors) -> None:
        for t in tensors:
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()

        def free(_, key=key, n=n):
            self._live.pop(key, None)
            self.held -= n
        self._live[key] = weakref.ref(st, free)
        self.held += n
        self.peak = max(self.peak, self.held)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, sh._dtensor_type()) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not None:
            return out     # DTensor's sharding propagation on fake tensors
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self._hold(t)
        packet = func._overloadpacket
        op = _COLLECTIVES.get(packet.__name__)
        if op is not None:
            group = _group_size(packet.__name__, args)
            operand, wire = collective_bytes(op, _bytes(outs), group)
            d = self.collectives.setdefault(
                op, {"count": 0, "operand_bytes": 0.0, "wire_bytes": 0.0})
            d["count"] += 1
            d["operand_bytes"] += operand
            d["wire_bytes"] += wire
            return out
        if packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs,
                                                  out_val=out))
        if not func.is_view and packet.__name__ != "wait_tensor":
            self.bytes_accessed += _bytes(tree_flatten((args, kwargs))[0]) \
                + _bytes(outs)
        return out


def _group_size(name: str, args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    return _resolve_process_group(args[-1]).size()


def _local_tensors(tree) -> list:
    """Rank 0's local tensor of every tensor leaf of ``tree`` (an LM
    module counts its parameters), each storage once."""
    leaves = []
    for x in tree_flatten(tree)[0]:
        leaves.extend(x.parameters() if isinstance(x, torch.nn.Module)
                      else [x])
    local = [t.to_local() if sh.is_dtensor(t) else t for t in leaves
             if isinstance(t, torch.Tensor)]
    return list({id(t): t for t in local}.values())


def build_cell(cfg: ArchConfig, shape_name: str, mesh, hints: ShardingHints,
               grad_accum: int = 1, dtype: torch.dtype = torch.bfloat16):
    """``(step, args)`` of one cell: its inputs as ``meta`` ``DTensor`` s
    on ``mesh``."""
    shp = SHAPES[shape_name]
    kind = shp["kind"]
    params = sh.distribute_params(cfg, mesh, abstract_params(cfg, dtype))
    if kind in ("train", "prefill"):
        batch = sh.distribute_batch(
            cfg, mesh, input_specs(cfg, shape_name, act_dtype=dtype))
    if kind == "train":
        params.requires_grad_(True)
        specs = sh.param_specs(cfg, mesh, params)

        def moment():   # optimizer state inherits the parameters' specs
            return {n: sh.distribute(torch.zeros(p.shape, dtype=torch.float32,
                                                 device="meta"), mesh,
                                     specs[n])
                    for n, p in params.named_parameters()}
        opt = AdamW()
        state = AdamWState(step=torch.zeros((), dtype=torch.int32,
                                            device="meta"),
                           m=moment(), v=moment())
        step = make_train_step(cfg, opt, grad_accum=grad_accum, remat=True,
                               hints=hints)
        return step, (params, state, batch)
    if kind == "prefill":
        return make_prefill_step(cfg, hints=hints), (params, batch)
    lanes, seq = shp["global_batch"], shp["seq_len"]
    kvcfg = make_paged_config(cfg, seq_len=seq, lanes=lanes, dtype=dtype)
    state, tenants = abstract_serve_state(cfg, kvcfg, lanes, seq)
    state = sh.distribute_state(cfg, mesh, state)
    return make_decode_step(cfg, kvcfg, tenants, hints=hints), (params, state)


def dry_run(cfg: ArchConfig, shape_name: str, mesh,
            grad_accum: int = 1) -> dict:
    """Run one cell's step on ``mesh`` (a mesh over the fake group) and
    count rank 0's terms (module docstring)."""
    step, args = build_cell(cfg, shape_name, mesh, ShardingHints(mesh),
                            grad_accum=grad_accum)
    return count_step(step, args)


def count_step(step, args: tuple) -> dict:
    """Run ``step(*args)`` once on ``DTensor`` arguments and count rank 0's
    terms (module docstring); ``args[0]`` is the LM."""
    inputs = _local_tensors(args)
    arg_bytes = _bytes(inputs)
    shard_max = max(p.to_local().numel() * p.element_size()
                    for p in args[0].parameters())
    counter = DeviceCounter()
    counter.track(inputs)
    with counter:
        out = step(*args)
    coll = counter.collectives
    return {
        "flops": counter.flops,
        "bytes_accessed": counter.bytes_accessed,
        "collective_bytes": coll,
        "collective_bytes_total": sum(d["operand_bytes"]
                                      for d in coll.values()),
        "collective_wire_total": sum(d["wire_bytes"] for d in coll.values()),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _bytes(_local_tensors(out)),
            "temp_peak_bytes": max(0, counter.peak - arg_bytes),
            "param_shard_max_bytes": shard_max,
        },
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             force: bool = False, results_dir: Optional[Path] = None
             ) -> dict:
    """Dry-run one (arch x shape) on one production mesh; returns the
    record (read back from its file unless ``force``)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_dir = Path(results_dir or RESULTS_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "ranks": 512 if multi_pod else 256,
                    "when": time.strftime("%Y-%m-%d %H:%M:%S")}
    if shape_name == "long_500k" and arch in LONG_SKIP:
        record["status"] = "skipped"
        record["reason"] = LONG_SKIP[arch]
        out_path.write_text(json.dumps(record, indent=2))
        return record
    t0 = time.perf_counter()
    try:
        with process_group("fake", record["ranks"]):
            mesh = make_production_mesh(multi_pod=multi_pod)
            record["per_device"] = dry_run(
                get_config(arch), shape_name, mesh,
                grad_accum=GRAD_ACCUM.get(arch, 2)
                if SHAPES[shape_name]["kind"] == "train" else 1)
        record["status"] = "ok"
        print(f"[{arch} | {shape_name} | {mesh_name}] ok "
              f"({time.perf_counter() - t0:.1f}s) "
              f"mem={record['per_device']['memory']}", flush=True)
    except Exception as e:  # noqa: BLE001 -- record failures as data
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[{arch} | {shape_name} | {mesh_name}] FAILED: "
              f"{record['error']}", flush=True)
    record["seconds"] = time.perf_counter() - t0
    out_path.write_text(json.dumps(record, indent=2))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all", *SHAPES])
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, multi_pod=mp, force=args.force)
                failures += rec.get("status") == "error"
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
