"""BENCHMARK.json against the benchmark's contract, and every cell's pieces
found by name."""
import json
import re

import pytest

from bench import harness

ROOT = harness.ROOT
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|expansion|d_model|d_ff|per_token")
WORKLOADS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])
            assert (ROOT / word).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_run_seconds_fits_a_full_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in MAN[k]}) == len(MAN[k])
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}


def test_configs_and_workloads():
    used = {w["config"] for w in MAN["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(MAN["workloads"])
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
            assert body["model"][k] != body["published"][k]
        for k, v in body["published"].items():
            if k in body["model"] and k not in c["reduced"]:
                assert body["model"][k] == v, k
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_to_files_and_reports_what_moves(workload):
    c = harness.cell(workload)
    bench = ROOT / "bench"
    assert (bench / "drivers" / f"{c['traffic']['driver']}.py").is_file()
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in e2e, (m["name"], m["moves"])
    harness.model_config(c["config"])
    assert c["limits"]


def test_every_metric_lists_cells_that_report_what_it_moves():
    for m in MAN["per_layer"]:
        for w in m.get("workloads", WORKLOADS):
            e2e = {x["name"] for x in harness.cell(w)["end_to_end"]}
            assert m["moves"] in e2e, (m["name"], w)


def test_files_under_paths_are_named_from_name_characters():
    for p in MAN["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel
