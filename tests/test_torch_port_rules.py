"""Rules of the PyTorch port (gatk_tpu_torch) that hold whatever it computes:
it imports neither jax nor gatk_tpu, its copies of gatk_tpu's host modules stay
verbatim, and its entry points refuse to fall back to the CPU without a card."""
import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import gatk_tpu_torch
from gatk_tpu_torch.ops import pairhmm
from gatk_tpu_torch.parallel import scheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gatk_tpu_torch")
HEADER = "# Copied verbatim from "


def _port_modules():
    """Every module of the port but __main__ (importing that runs the CLI)."""
    return sorted(m.name for m in pkgutil.walk_packages(gatk_tpu_torch.__path__, "gatk_tpu_torch.")
                  if not m.name.endswith("__main__"))


def _copied_files():
    out = []
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    if fh.readline().startswith(HEADER):
                        out.append(os.path.relpath(path, ROOT))
    return sorted(out)


def test_port_imports_neither_jax_nor_gatk_tpu():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'gatk_tpu'))\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(_port_modules()) > 50


def test_every_module_named_in_a_header_is_copied():
    assert len(_copied_files()) == 53


def _is_import(node):
    return isinstance(node, (ast.Import, ast.ImportFrom))


def _import_lines(src):
    lines = set()
    for node in ast.walk(ast.parse(src)):
        if _is_import(node):
            lines.update(range(node.lineno, node.end_lineno + 1))
    return lines


@pytest.mark.parametrize("copy", _copied_files())
def test_copied_module_is_verbatim(copy):
    with open(os.path.join(ROOT, copy)) as fh:
        header = fh.readline()
        body = fh.read()
    source = header[len(HEADER):].split(";")[0]
    assert source == "gatk_tpu/" + os.path.relpath(copy, "gatk_tpu_torch")
    with open(os.path.join(ROOT, source)) as fh:
        original = fh.read()
    if copy.endswith("calling/hc_engine.py"):
        # the PairHMM module's name at its five uses (hc_engine.py:18,332,407,518,549)
        lines = original.splitlines(keepends=True)
        for n in (18, 332, 407, 518, 549):
            assert "pairhmm_tpu" in lines[n - 1]
            lines[n - 1] = lines[n - 1].replace("pairhmm_tpu", "pairhmm")
        original = "".join(lines)
    a, b = original.splitlines(), body.splitlines()
    assert len(a) == len(b)
    skip = _import_lines(original) | _import_lines(body)
    diff = [i + 1 for i, (x, y) in enumerate(zip(a, b)) if x != y and i + 1 not in skip]
    assert diff == []


def test_sharded_caller_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scheduler.ShardedCaller(engine=None)
    caller = scheduler.ShardedCaller(engine=None, devices=[torch.device("cpu")])
    assert [b.device.type for b in caller.batchers] == ["cpu"]


def test_pairhmm_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pairhmm, "_DEFAULT_DEVICE", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pairhmm.PoolBatcher()
    reads = [dict(bases=b"ACGT", rq=[30] * 4, iq=[45] * 4, dq=[45] * 4, gcp=[10] * 4)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pairhmm.compute_likelihood_matrix(reads, [b"ACGTACGT"])
    pairhmm.set_default_device("cpu")
    assert pairhmm.compute_likelihood_matrix(reads, [b"ACGTACGT"]).shape == (1, 1)


def test_kernel_wrapper_refuses_cpu_tensors():
    from gatk_tpu_torch.ops import _kernels

    pools = pairhmm.Pools(*(torch.zeros((160, 1), dtype=torch.uint8),) * 5,
                          torch.ones(1, dtype=torch.int32),
                          torch.zeros((512 + 320 + 16, 1), dtype=torch.uint8),
                          torch.ones(1, dtype=torch.int32))
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        _kernels.pairhmm_fwd(pools, idx, idx)
