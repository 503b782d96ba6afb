"""Everything a run needs, found by name: the cell in BENCHMARK.json, its
configuration's file, its traffic mix (traffic/<mix>.json), the limits that
decide `correct` (limits/<cell>.json), and each metric's reader
(metrics/<metric>.py, one module a metric with a `read(run)` function). A
later cell, mix or metric is a new file and a new entry; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def _reports(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell(name, root=ROOT, bench_dir=BENCH_DIR):
    """The cell `name`: dict(workload, config, traffic, params, limits,
    end_to_end, per_layer), where params are the configuration's generator
    keys under the traffic's overrides, and the metric lists hold the
    BENCHMARK.json entries this cell reports."""
    bench = load(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    params = dict(config["sample"])
    params.update(traffic.get("sample", {}))
    limits = _json(os.path.join(bench_dir, "limits", f"{name}.json"))["limits"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return dict(workload=w, config=config, traffic=traffic, params=params, limits=limits,
                end_to_end=e2e, per_layer=layer)


def reader(metric_name, bench_dir=BENCH_DIR):
    """The `read(run)` function of metrics/<metric_name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{metric_name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric_name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries, run, bench_dir=BENCH_DIR):
    """{name: {"value", "unit"}} of each entry whose reader found something."""
    out = {}
    for m in entries:
        value = reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
