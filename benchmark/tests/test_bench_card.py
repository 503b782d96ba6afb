"""On the card: a short run of each cell at a small pool, through the
kernels, comes out correct. Skips without a card.

    python -m pytest benchmark/tests/test_bench_card.py -q -m cuda
"""
import pytest

from conftest import small_cell
from yardstick import runner


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hc_wgs30x.vcf", "m2_tumor200x.vcf", "hc_wgs30x.gvcf"])
def test_short_run_on_the_card(cuda_device, name):
    cell = small_cell(name, 2)
    result, rows = runner.execute(name, 11, 2.0, True, 0.0, device=cuda_device, cell=cell,
                                  emit=lambda line: None)
    assert result["correct"], [r for r in rows if not r[3]]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
