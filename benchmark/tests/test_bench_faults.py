"""A whole run on the CPU, past the harness's look for a card, at a size a
test holds: the program comes out correct under the cell's committed limits,
and the control (the plain PairHMM in bfloat16 in the kernels' place) and
each fault a calling cell can have come out not correct: half of each
launch's pairs left out and the mean of the rest put in their place, and
every record altered where the VCF writer writes it. (A state left unchanged
and an exchange between chips left out do not arise: no cell trains, and
every cell runs on one card.)"""
import pytest

from conftest import small_cell
from yardstick import runner

SIZES = {  # cell: (shards, shard bp, seconds)
    "hc_wgs30x.vcf": (2, 3000, 0.5),
    "m2_tumor200x.vcf": (1, 2000, 0.1),
    "hc_wgs30x.gvcf": (2, 2000, 0.5),
}
MODES = ("program", "control", "half_batch", "records_altered")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SIZES))
def test_correct_only_for_the_program(name, mode):
    shards, bp, seconds = SIZES[name]
    cell = small_cell(name, shards, bp)
    result, rows = runner.execute(name, 2**32 + 7, seconds, False, 0.0, device="cpu",
                                  mode=mode, cell=cell, emit=lambda line: None)
    assert result["attempted"] >= 1
    failed = [n for n, _, _, ok in rows if not ok]
    if mode == "program":
        assert result["correct"], failed
    else:
        assert not result["correct"]
        if mode in ("control", "half_batch"):
            assert "pairhmm_max_gap" in failed
