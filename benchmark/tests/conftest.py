"""Tests of the benchmark's harness. CPU tests run anywhere; tests marked
`cuda` need a card and skip without one (decided in the fixture).

    python -m pytest benchmark/tests -q
"""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def small_cell(name, shards=2, shard_bp=None):
    """The cell `name` of BENCHMARK.json with a pool of `shards` shards, each
    of shard_bp bp (the cell's own by default): a size a test run holds."""
    from yardstick import catalog

    cell = catalog.cell(name)
    bp = shard_bp or cell["params"]["shard_bp"]
    cell["params"].update(shard_bp=bp, genome_bp=shards * bp)
    return cell
