"""The run's import check, and a reference that imports nothing of the
program."""
import ast
import os
import sys

from yardstick import catalog, core

REFERENCE = ("plain_pairhmm.py", "judge.py", "gen.py", "bamio.py", "roofline.py")


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for name in REFERENCE:
        found = _imports(os.path.join(catalog.BENCH_DIR, "yardstick", name))
        assert not found & {"gatk_tpu", "gatk_tpu_torch", "jax", "jaxlib", "flax"}, name


def test_whole_top_level_names(monkeypatch):
    for name in ("gatk_tpu_torch", "gatk_tpu_torch.ops", "jaxtyping_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    base = set(core.forbidden_modules())
    assert not base & {"gatk_tpu_torch", "jaxtyping_like", "flaxen"}
    monkeypatch.setitem(sys.modules, "gatk_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"gatk_tpu", "jax"} <= set(core.forbidden_modules())


def test_the_port_loads_no_jax():
    import subprocess

    code = ("import sys; sys.path[:0] = [%r, %r]; from yardstick import core; "
            "import gatk_tpu_torch.cli; print(core.forbidden_modules())"
            % (catalog.BENCH_DIR, catalog.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
