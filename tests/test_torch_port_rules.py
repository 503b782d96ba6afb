"""Rules of the PyTorch port (gatk_tpu_torch) that hold whatever it computes:
it imports neither jax nor gatk_tpu, its copies of gatk_tpu's host modules stay
verbatim (cnv/somatic.py but for build_panel_of_normals), and its entry points
refuse to fall back to the CPU without a card."""
import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import gatk_tpu_torch
from gatk_tpu_torch import devices
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
    assert len(_copied_files()) == 129


def _is_import(node):
    return isinstance(node, (ast.Import, ast.ImportFrom))


def _import_lines(src):
    lines = set()
    for node in ast.walk(ast.parse(src)):
        if _is_import(node):
            lines.update(range(node.lineno, node.end_lineno + 1))
    return lines


# the lines a copy may change beyond its imports: the PairHMM module's name at
# its uses, the --device flags, and the lines EDITED lists
RENAMED = {"calling/hc_engine.py": (18, 332, 407, 518, 549),
           "mutect/engine.py": (23, 158, 197, 232)}
# copy -> {line of the original: (the start of its text, its text in the copy)}:
# ReadsPipeline hands its --device flag on to HaplotypeCaller, which would
# default to cuda; the test-data locator's default root is the checkout's
# reference/ directory, not the path of the machine gatk_tpu was written on;
# GenerateToolWdl's WDL task runs the port's package, not gatk_tpu
EDITED = {"tools/analysis_tools.py": {540: (
    '                   "-ERC", args.emit_ref_confidence,\n',
    '                   "-ERC", args.emit_ref_confidence, "--device", args.device,\n')},
          "utils/testdata.py": {8: (
    'REFERENCE_ROOT = os.environ.get("GATK_REFERENCE_ROOT", ',
    'REFERENCE_ROOT = os.environ.get("GATK_REFERENCE_ROOT", '
    'f"{os.path.dirname(__file__)}/../../reference")\n')},
          "tools/barclay_tools.py": {111: (
    '    python -m gatk_tpu {name} ',
    '    python -m gatk_tpu_torch {name} \\\\\n')}}
# the PairHMM's flag: Mutect2, RampedHaplotypeCaller, HaplotypeBasedVariantRecaller,
# ReadsPipeline, FlowPairHMMAlignReadsToHaplotypes
MUTECT2_DEVICE_FLAG = [
    '    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",\n',
    '                   help="where the PairHMM runs: the CUDA kernel, or its plain "\n',
    '                        "PyTorch version on the host")\n',
]
GCNV_DEVICE_FLAG = [
    '    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",\n',
    '                   help="where the denoising model and its copy-number HMM run: the "\n',
    '                        "CUDA kernel, or the plain PyTorch version on the host")\n',
]
PON_DEVICE_FLAG = [
    '    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",\n',
    '                   help="where the panel\'s SVD runs: the CUDA device or the host")\n',
]
MODEL_SEGMENTS_DEVICE_FLAG = [
    '    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",\n',
    '                   help="where the slice-sampling chains run: the CUDA device or the host")\n',
]
# copy -> [(line of the tool's parse_args in the original, the flag's lines)]:
# each flag goes before that line, and devices.set_default_device(args.device)
# after it
DEVICE_FLAGS = {
    "tools/mutect_tool.py": [(38, MUTECT2_DEVICE_FLAG)],
    "tools/cnv_tools.py": [(72, GCNV_DEVICE_FLAG)],
    "tools/somatic_cnv_tools.py": [(326, PON_DEVICE_FLAG), (452, MODEL_SEGMENTS_DEVICE_FLAG)],
    "tools/ramped_hc_tool.py": [(86, MUTECT2_DEVICE_FLAG)],
    "tools/variant_recalling_tool.py": [(54, MUTECT2_DEVICE_FLAG)],
    "tools/analysis_tools.py": [(521, MUTECT2_DEVICE_FLAG)],  # ReadsPipeline
    "tools/misc_tools.py": [(870, MUTECT2_DEVICE_FLAG)],  # FlowPairHMMAlignReadsToHaplotypes
}

# copy -> (n, the start of the original's line n + 1): where a tool with a
# --device flag imports the devices module
DEVICES_IMPORT = {"tools/mutect_tool.py": (9, "\n"),
                  "tools/cnv_tools.py": (9, "from ..cli import"),
                  "tools/somatic_cnv_tools.py": (15, "from ..cli import"),
                  "tools/ramped_hc_tool.py": (32, "\n"),
                  "tools/variant_recalling_tool.py": (20, "\n"),
                  "tools/analysis_tools.py": (17, "from ..cli import"),
                  "tools/misc_tools.py": (15, "from ..cli import")}


def _expected_changes(copy, original):
    """The source as its copy must read, apart from import lines."""
    lines = original.splitlines(keepends=True)
    rel = os.path.relpath(copy, "gatk_tpu_torch")
    for n in RENAMED.get(rel, ()):
        assert "pairhmm_tpu" in lines[n - 1]
        lines[n - 1] = lines[n - 1].replace("pairhmm_tpu", "pairhmm")
    for n, (old, new) in EDITED.get(rel, {}).items():
        assert lines[n - 1].startswith(old)
        lines[n - 1] = new
    for n, flag in sorted(DEVICE_FLAGS.get(rel, ()), reverse=True):
        assert lines[n - 1] == "    args = p.parse_args(argv)\n"
        lines[n:n] = ["    devices.set_default_device(args.device)\n"]
        lines[n - 1:n - 1] = flag
    if rel in DEVICES_IMPORT:
        # the import of the devices module goes after the original's line n
        n, before = DEVICES_IMPORT[rel]
        assert lines[n].startswith(before)
        lines[n:n] = ["from .. import devices\n"]
    return "".join(lines)


@pytest.mark.parametrize("copy", _copied_files())
def test_copied_module_is_verbatim(copy):
    with open(os.path.join(ROOT, copy)) as fh:
        header = fh.readline()
        body = fh.read()
    source = header[len(HEADER):].split(";")[0]
    assert source == "gatk_tpu/" + os.path.relpath(copy, "gatk_tpu_torch")
    with open(os.path.join(ROOT, source)) as fh:
        original = fh.read()
    original = _expected_changes(copy, original)
    a, b = original.splitlines(), body.splitlines()
    assert len(a) == len(b)
    skip = _import_lines(original) | _import_lines(body)
    diff = [i + 1 for i, (x, y) in enumerate(zip(a, b)) if x != y and i + 1 not in skip]
    assert diff == []


def _top_level_blocks(src, skip):
    """The source of each top-level statement but imports and the function
    named `skip`, and the module docstring, in order."""
    tree = ast.parse(src)
    return [ast.get_source_segment(src, node) for node in tree.body
            if not _is_import(node) and getattr(node, "name", None) != skip]


def test_somatic_is_a_copy_but_for_the_panel_svd():
    """cnv/somatic.py is gatk_tpu's but for its import lines and
    build_panel_of_normals, whose SVD runs in PyTorch on a device."""
    with open(os.path.join(PORT, "cnv", "somatic.py")) as fh:
        header, body = fh.readline(), fh.read()
    assert header.startswith("# Copied from gatk_tpu/cnv/somatic.py;")
    with open(os.path.join(ROOT, "gatk_tpu", "cnv", "somatic.py")) as fh:
        original = fh.read()
    skip = "build_panel_of_normals"
    assert _top_level_blocks(body, skip) == _top_level_blocks(original, skip)
    assert "torch.linalg.svd" in body and "jax" not in body


def test_sharded_caller_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scheduler.ShardedCaller(engine=None)
    caller = scheduler.ShardedCaller(engine=None, devices=[torch.device("cpu")])
    assert [b.device.type for b in caller.batchers] == ["cpu"]


def test_pairhmm_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pairhmm.PoolBatcher()
    reads = [dict(bases=b"ACGT", rq=[30] * 4, iq=[45] * 4, dq=[45] * 4, gcp=[10] * 4)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pairhmm.compute_likelihood_matrix(reads, [b"ACGTACGT"])
    devices.set_default_device("cpu")
    assert pairhmm.compute_likelihood_matrix(reads, [b"ACGTACGT"]).shape == (1, 1)


def test_mutect2_on_cuda_raises_without_a_card(monkeypatch, tmp_path):
    """Mutect2 --device cuda (the default) refuses to start without a card, through
    the CLI, before it reads its inputs; --device cpu runs."""
    from gatk_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cuda"))
    argv = ["Mutect2", "-I", str(tmp_path / "missing.bam"), "-R", str(tmp_path / "missing.fa"),
            "-O", str(tmp_path / "out.vcf")]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv + extra)
    assert devices._DEFAULT_DEVICE == torch.device("cuda")
    assert cli.main(argv + ["--device", "cpu"]) == 2  # gets as far as the missing files
    assert not (tmp_path / "out.vcf").exists()


def test_kernel_wrapper_refuses_cpu_tensors():
    from gatk_tpu_torch.ops import _kernels

    pools = pairhmm.Pools(*(torch.zeros((160, 1), dtype=torch.uint8),) * 5,
                          torch.ones(1, dtype=torch.int32),
                          torch.zeros((512 + 320 + 16, 1), dtype=torch.uint8),
                          torch.ones(1, dtype=torch.int32))
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        _kernels.pairhmm_fwd(pools, idx, idx)


@pytest.mark.parametrize("tool,argv", [
    ("GermlineCNVCaller", ["-I", "{d}/missing.tsv", "--contig-ploidy-calls", "{d}/calls",
                           "-O", "{d}/out"]),
    ("CreateReadCountPanelOfNormals", ["-I", "{d}/missing.tsv", "-O", "{d}/pon.hdf5"]),
    ("ModelSegments", ["--denoised-copy-ratios", "{d}/missing.tsv", "-O", "{d}/out",
                       "--output-prefix", "case"]),
])
def test_cnv_tools_on_cuda_raise_without_a_card(monkeypatch, tmp_path, tool, argv):
    """--device cuda (the default) refuses to start without a card, through the
    CLI, before the tool reads its inputs; --device cpu gets past that point
    (as far as the missing input)."""
    from gatk_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cuda"))
    argv = [tool] + [a.format(d=tmp_path) for a in argv]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv + extra)
    assert cli.main(argv + ["--device", "cpu"]) == 2  # the missing input
    assert devices._DEFAULT_DEVICE == torch.device("cpu")


def test_cnv_hmm_wrapper_refuses_cpu_tensors():
    from gatk_tpu_torch.ops import _kernels

    x = torch.zeros((2, 3, 6))
    with pytest.raises(ValueError, match="not a CUDA device"):
        _kernels.cnv_hmm(x, x, torch.zeros(2))
