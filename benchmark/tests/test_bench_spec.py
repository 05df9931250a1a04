"""Every cell, configuration, traffic file and metric reader of
``BENCHMARK.json`` loads by name, and the file keeps to the shape the
benchmark's own rules set (names, sizes, units, bounds)."""

import json
import os
import re

import pytest

from kbbench import readers, spec

with open(spec.ROOT / "BENCHMARK.json", encoding="utf-8") as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert spec.bench_path(f"checks/{c.traffic['check']}.py").exists()
    assert os.path.exists(spec.bench_path(c.config["program"]))
    bytes.fromhex(c.config["seed_hex"])
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert cfg["file"].startswith("benchmark/")
    with open(spec.ROOT / cfg["file"], encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert key in doc and NAME.match(key)
    assert doc["source"] == cfg["source"]
    assert "assumed" in doc
    assert sum(w["config"] == cfg["name"] for w in BENCH["workloads"]) >= 1


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader_loads(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(readers.reader(m["name"]).read)
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("name", sorted(
    os.listdir(spec.bench_path("configs"))))
def test_every_configuration_file_is_whole(name):
    with open(spec.bench_path(f"configs/{name}"), encoding="utf-8") as f:
        c = json.load(f)
    for key in ("source", "assumed", "reduced", "driver", "instrumentation",
                "mutator", "program", "seed_hex", "lanes",
                "instrumentation_options"):
        assert key in c, key
    assert os.path.exists(spec.bench_path(c["program"]))


@pytest.mark.parametrize("name", sorted(
    os.listdir(spec.bench_path("workloads"))))
def test_every_traffic_file_is_whole(name):
    with open(spec.bench_path(f"workloads/{name}"), encoding="utf-8") as f:
        t = json.load(f)
    assert spec.bench_path(f"checks/{t['check']}.py").exists()
    assert t["warmup_steps"] >= 1 and t["profile_steps"] >= 1
    assert isinstance(t["flags"], list) and t["why"]
    assert "sample" not in t
    if t["check"] == "generations":
        # the -G ring's sizes are the traffic's, not the program's
        # defaults: the reference reads them from here
        o = t["instrumentation_options"]
        assert o["gen_ring_slots"] >= 2 and o["gen_admits"] >= 1
        assert o["gen_findings_cap"] >= 1


@pytest.mark.parametrize("name", sorted(
    os.listdir(spec.bench_path("checks"))))
def test_every_check_kind_loads(name):
    from kbbench import check
    mod = check.kind(name[:-3])
    assert callable(mod.check) and callable(mod.control)


@pytest.mark.parametrize("name", sorted(
    os.listdir(spec.bench_path("hooks"))))
def test_every_hook_names_a_function_of_the_program(name):
    import importlib
    with open(spec.bench_path(f"hooks/{name}"), encoding="utf-8") as f:
        h = json.load(f)
    assert h["why"] and h["wrap"]
    for mod, attr in h["wrap"]:
        assert callable(getattr(importlib.import_module(mod), attr))


def test_names_unique_and_sized():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
