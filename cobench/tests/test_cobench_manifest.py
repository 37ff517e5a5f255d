"""The manifest finds every part of a cell by its name, and a new part is a
new file that no existing file has to name."""

import json
from pathlib import Path

from cobench import manifest

HERE = Path(manifest.__file__).resolve().parent


def test_finds_config_traffic_metric_and_prover_by_name():
    bench = manifest.load_benchmark()
    cell = manifest.workload(bench, "groth16_rep3_2p20")
    assert manifest.load_config(cell["config"])["prover"] == "groth16"
    assert manifest.load_traffic(cell["traffic"])["protocol"] == "rep3"
    assert callable(manifest.metric_reader("g16.witness_map_s"))
    assert hasattr(manifest.prover("groth16"), "Cell")


def test_every_entry_of_the_benchmark_has_its_files():
    bench = manifest.load_benchmark()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (manifest.REPO / c["file"]).is_file()
        assert c["file"] == f"cobench/configs/{c['name']}.json"
        manifest.prover(manifest.load_config(c["name"])["prover"])
    for w in bench["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        manifest.load_traffic(w["traffic"])
    for m in bench["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m.get("workloads", [])) <= {w["name"] for w in bench["workloads"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = manifest.load_benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_for(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_for(bench, w["name"], True)


def test_a_new_config_traffic_and_metric_are_found_without_editing(tmp_path):
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "extra.json").write_text(json.dumps({"prover": "groth16", "x": 1}))
    (tmp_path / "traffic" / "extra_mix.json").write_text(json.dumps({"protocol": "shamir"}))
    (tmp_path / "metrics" / "extra.count_s.py").write_text(
        "def read(run):\n    return 2.5 * len(run)\n")
    assert manifest.load_config("extra", tmp_path)["x"] == 1
    assert manifest.load_traffic("extra_mix", tmp_path)["protocol"] == "shamir"
    assert manifest.metric_reader("extra.count_s", tmp_path)([1, 2]) == 5.0
    assert not (HERE / "configs" / "extra.json").exists()


def test_a_metric_without_workloads_applies_everywhere():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}], "per_layer": []}
    assert [m["name"] for m in manifest.metrics_for(bench, "y", False)] == ["a"]
    assert [m["name"] for m in manifest.metrics_for(bench, "x", False)] == ["a", "b"]


def test_benchmark_json_keeps_the_contracts_limits():
    import re

    bench = manifest.load_benchmark()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32 and 1 <= bench["run_seconds"] <= 51
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (manifest.REPO / p).is_dir()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert len(c["reduced"]) <= 16 and all(name.match(k) for k in c["reduced"])
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"]) and len(w["why"]) <= 200
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
    assert (manifest.REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
