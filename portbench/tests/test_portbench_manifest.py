"""``BENCHMARK.json`` against the benchmark's contract: its keys, the
characters of its names and units, one file for every configuration,
traffic mix, per-layer metric and reference, what each cell reports, and
a run length that fits a full check of 24 cells."""
import json
import re
from pathlib import Path

import pytest

from portbench import core

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    for w in MAN["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = {}
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in MAN[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and _line(e["why"])
            names.setdefault(group, set()).add(e["name"])
    for group in ("end_to_end", "per_layer"):
        for m in MAN[group]:
            base = {"name", "unit", "better", "source"} | (
                {"bound"} if group == "end_to_end" else {"layer", "moves"})
            assert base <= set(m) <= base | {"workloads"}, m
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            assert set(m.get("workloads", [])) <= names["workloads"]
    every = [m["name"] for g in ("end_to_end", "per_layer") for m in MAN[g]]
    assert len(every) == len(set(every))
    assert len(MAN["workloads"]) <= 24 and len(MAN["configs"]) <= 24


def test_files_exist_by_name():
    here = ROOT / "portbench"
    for c in MAN["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("portbench/")
        conf = json.loads(f.read_text())
        assert conf["name"] == c["name"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (here / "reference" / f"{c['name']}.py").is_file()
    for w in MAN["workloads"]:
        assert (here / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["config"] in {c["name"] for c in MAN["configs"]}
        assert w["chips"] == 1
    for m in MAN["per_layer"]:
        assert core.reader_path(m["name"]).is_file(), m["name"]
    for kernel in ("paged_attention", "flash_attention", "support_core"):
        assert (here / "work" / f"{kernel}.py").is_file()


def test_each_cell_reports_enough():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for w in MAN["workloads"]:
        def has(m):
            return "workloads" not in m or w["name"] in m["workloads"]
        got = [m["name"] for m in e2e.values() if has(m)]
        assert "setup_s" in got and len(got) >= 2
        per = [m for m in MAN["per_layer"] if has(m)]
        assert per
        for m in per:
            assert m["moves"] in got
    for m in MAN["per_layer"]:
        assert _line(m["layer"])
        layers.setdefault(m["layer"], 0)
        if m["name"].endswith("roofline") or "roofline." in m["name"]:
            assert m["unit"] == "%"
    # a kernel roofline that moves a metric has an mfu beside it
    for m in MAN["per_layer"]:
        if "roofline" in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       for o in MAN["per_layer"])


@pytest.mark.parametrize("cells", [24])
def test_run_seconds_fit_a_full_check(cells):
    s = MAN["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * cells
    assert runs * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name,file", [
    ("decode_step_ms", "decode_step_ms.py"),
    ("decode_step_ms.open", "decode_step_ms.py"),
    ("step_mfu.open_rate", "step_mfu.py"),
    ("ttft_p90_ms.open_rate", "ttft_p90_ms.open_rate.py"),
    ("no_such_metric.open", "no_such_metric.py"),
])
def test_variant_names_find_their_base_reader(name, file):
    assert core.reader_path(name) == ROOT / "portbench" / "metrics" / file
