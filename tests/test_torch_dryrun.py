"""The port's dry run (``repro_torch.launch.dryrun``) and roofline on the
CPU, over PyTorch's fake process group (no collective is sent).

* One smoke cell of each kind (train, prefill, decode) runs on fake (2,
  2) and (16, 16) meshes: its argument bytes are the spec-derived bytes of
  rank 0's shards, its counts are positive, and its roofline row is well
  formed.
* A ``LONG_SKIP`` cell is recorded ``skipped``; a failing cell is recorded
  as data with its traceback, and the CLI then exits 1.

Each test opens its process group in a fixture and destroys it after, so
no group outlives the test on its worker.
"""
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import process_group  # noqa: E402
from repro_torch.models import abstract_params, input_specs  # noqa: E402
from repro_torch.models import make_paged_config  # noqa: E402
from repro_torch.serve.serve_step import abstract_serve_state  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

MESHES = {"2x2": (2, 2), "16x16": (16, 16)}


@pytest.fixture(params=list(MESHES))
def mesh(request):
    shape = MESHES[request.param]
    with process_group("fake", shape[0] * shape[1]):
        yield init_device_mesh("cuda", shape,
                               mesh_dim_names=("data", "model"))


def _spec_bytes(cfg, shape_name, mesh) -> int:
    """Rank 0's argument bytes from the specs alone: the largest shard of
    every parameter (and for training its two f32 moments), batch input or
    serving-state leaf."""
    sizes = sh.mesh_sizes(mesh)
    params = abstract_params(cfg)
    pspecs = sh.param_specs(cfg, sizes, params)
    total = 0
    for n, p in params.named_parameters():
        total += sh.shard_bytes(tuple(p.shape), p.element_size(), sizes,
                                pspecs[n])
    shp = SHAPES[shape_name]
    if shp["kind"] == "train":
        total += sum(2 * sh.shard_bytes(tuple(p.shape), 4, sizes, pspecs[n])
                     for n, p in params.named_parameters()) + 4   # + step
    if shp["kind"] in ("train", "prefill"):
        batch = input_specs(cfg, shape_name)
        for k, spec in sh.batch_specs(cfg, sizes, batch).items():
            total += sh.shard_bytes(tuple(batch[k].shape),
                                    batch[k].element_size(), sizes, spec)
        return total
    kv = make_paged_config(cfg, seq_len=shp["seq_len"],
                           lanes=shp["global_batch"])
    state, _ = abstract_serve_state(cfg, kv, shp["global_batch"],
                                    shp["seq_len"])
    specs = sh.serve_state_specs(cfg, sizes, state)
    for path, t in sh._leaves(state):
        total += sh.shard_bytes(tuple(t.shape), t.element_size(), sizes,
                                specs[path])
    return total


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_smoke_cell_runs_and_counts(mesh, shape_name):
    cfg = smoke_config("deepseek-7b")
    rec = dryrun.dry_run(cfg, shape_name, mesh)
    mem = rec["memory"]
    assert mem["argument_bytes"] == _spec_bytes(cfg, shape_name, mesh)
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert mem["output_bytes"] > 0 and mem["temp_peak_bytes"] >= 0
    assert rec["collective_bytes"], "a sharded step moves data"
    for op, d in rec["collective_bytes"].items():
        assert op in ("all-gather", "reduce-scatter", "all-reduce",
                      "all-to-all", "collective-permute")
        assert d["count"] > 0 and d["wire_bytes"] >= 0
    row = roofline.roofline_row("deepseek-7b", shape_name, record={
        "status": "ok", "ranks": mesh.size(), "per_device": rec})
    assert row["dominant"] in ("compute", "memory", "collective")
    for key in ("compute_s", "memory_s", "collective_s",
                "roofline_fraction", "hbm_gb_per_dev"):
        assert math.isfinite(row[key]) and row[key] >= 0, key
    assert "|" in roofline.markdown_table([row])


def test_long_skip_cell_is_skipped(tmp_path):
    rec = dryrun.run_cell("deepseek-7b", "long_500k", multi_pod=False,
                          force=True, results_dir=tmp_path)
    assert rec["status"] == "skipped"
    assert rec["reason"] == dryrun.LONG_SKIP["deepseek-7b"]
    saved = json.loads((tmp_path / "deepseek-7b__long_500k__pod16x16.json"
                        ).read_text())
    assert saved["status"] == "skipped"
    row = roofline.roofline_row("deepseek-7b", "long_500k",
                                results_dir=tmp_path)
    assert row["status"] == "skipped"


def test_error_is_recorded_and_main_exits_1(tmp_path, monkeypatch):
    def planted(*a, **k):
        raise RuntimeError("planted fault")
    monkeypatch.setattr(dryrun, "dry_run", planted)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "deepseek-7b", "--shape", "decode_32k",
                     "--mesh", "pod", "--force"])
    assert exit_.value.code == 1
    rec = json.loads((tmp_path / "deepseek-7b__decode_32k__pod16x16.json"
                      ).read_text())
    assert rec["status"] == "error"
    assert "planted fault" in rec["error"] and "Traceback" in rec["traceback"]
    assert not torch.distributed.is_initialized()
