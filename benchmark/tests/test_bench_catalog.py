"""BENCHMARK.json against the benchmark's contract (names, units, keys,
bounds), every name resolving to its files, and a cell, a mix and a metric
added as files and entries only, which the harness finds without an edit."""
import json
import os
import re
import shutil

import pytest

from yardstick import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.fixture(scope="module")
def bench():
    return catalog.load()


def test_keys_and_sizes(bench):
    assert os.path.getsize(os.path.join(catalog.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(".." not in p.split("/") and not p.startswith("/") for p in bench["paths"])
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    files = [w for w in cmd if os.path.exists(os.path.join(catalog.ROOT, w))]
    assert all(any(f.startswith(p + "/") for p in bench["paths"]) for f in files)
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128


def test_entries(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        with open(os.path.join(catalog.ROOT, c["file"])) as fh:
            body = json.load(fh)
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in body  # each cut stated in the file
            if key in body["sample"]:  # and the generator runs it
                assert body["sample"][key] == body[key]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["name"].endswith("_roofline") or "mfu" in m["name"]
            assert m["unit"] == "%"


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cell = catalog.cell(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(catalog.reader(m["name"]))
        assert cell["traffic"]["argv"] and cell["limits"]
    layers = {}
    for m in bench["per_layer"]:  # one layer, one name
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_cell_mix_and_metric_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(catalog.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = catalog.load()
    bench["workloads"].append(dict(name="hc_wgs30x.tiny", config="hc_wgs30x", traffic="hc_tiny",
                                   chips=1, why="a throwaway cell"))
    bench["per_layer"].append(dict(name="calls.count", unit="calls", better="higher",
                                   source="host_clock", layer="front end", moves="reads_per_s",
                                   workloads=["hc_wgs30x.tiny"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b = root / "benchmark"
    (b / "traffic" / "hc_tiny.json").write_text(json.dumps(dict(
        argv=["HaplotypeCaller", "--device", "{device}"], sample=dict(genome_bp=4000,
                                                                      shard_bp=2000),
        judge=dict(kinds=["germline"]))))
    shutil.copy(b / "limits" / "hc_wgs30x.vcf.json", b / "limits" / "hc_wgs30x.tiny.json")
    (b / "metrics" / "calls.count.py").write_text("def read(run):\n    return len(run.calls)\n")
    cell = catalog.cell("hc_wgs30x.tiny", root=str(root), bench_dir=str(b))
    assert cell["params"]["genome_bp"] == 4000 and cell["params"]["depth"] == 30
    assert [m["name"] for m in cell["per_layer"]][-1] == "calls.count"
    from yardstick import runner

    result, _ = runner.execute("hc_wgs30x.tiny", 9, 0.5, True, 0.0, device="cpu",
                               root=str(root), bench_dir=str(b), emit=lambda line: None)
    assert result["metrics"]["calls.count"] == {"value": result["attempted"], "unit": "calls"}
    assert result["correct"]
