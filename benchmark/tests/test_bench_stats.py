"""The end-to-end metrics over a window whose last call overruns it, and the
roofline arithmetic on a hand-worked launch."""
from types import SimpleNamespace

import pytest

from yardstick import catalog, roofline


def _run(walls, reads, window_s):
    return SimpleNamespace(calls=[dict(wall=w, reads=r, rc=0) for w, r in zip(walls, reads)],
                           reads=sum(reads), window_s=window_s, setup_s=12.5)


def test_rate_over_an_overrunning_window():
    # a 10 s window: 36 calls of 0.2 s and 3 of 1.0 s, then one that starts
    # at 10.2 - 0.2 s and ends at 14.0 s; the window closes with it
    walls = [0.2] * 36 + [1.0] * 3 + [4.0]
    reads = [2000] * 40
    run = _run(walls, reads, window_s=14.0)
    assert catalog.reader("reads_per_s")(run) == pytest.approx(80000 / 14.0)
    # not the median call's rate
    assert catalog.reader("reads_per_s")(run) != pytest.approx(2000 / 0.2)
    assert catalog.reader("setup_s")(run) == 12.5


def test_no_calls_no_reading():
    run = _run([], [], window_s=10.0)
    assert catalog.reader("reads_per_s")(run) is None


def test_bound_of_a_hand_worked_launch():
    # 1,000 pairs of a 100-base read and a 200-base haplotype: 2e7 cells x 11
    # operations = 2.2e8 / 67e12 s = 3.2836e-3 ms; bytes: 5 read tables of
    # 160 x 1,000, e 848 x 100 and the lengths, 8 bytes a pair in, 4 out
    cells = 1000 * 100 * 200
    in_bytes = 5 * 160 * 1000 + 848 * 100 + 4 * 1100 + 8 * 1000
    b = roofline.bound(cells, in_bytes, 4 * 1000)
    assert b["ops_bound_ms"] == pytest.approx(2.2e8 / 67e12 * 1e3)
    assert b["bytes_bound_ms"] == pytest.approx((in_bytes + 4000) / 3.35e12 * 1e3)
    assert b["bound_by"] == "operations" and b["bound_ms"] == b["ops_bound_ms"]
    # a kernel that took 0.1 ms (sweep 0.06, plan 0.04) is at 3.28 % of it
    run = SimpleNamespace(trace=dict(kernel_ns={"pairhmm_fwd": 100_000, "pairhmm_matrix": 0}),
                          bounds=[dict(kind="pairhmm_fwd", **b)])
    assert catalog.reader("pairhmm_fwd_roofline")(run) == pytest.approx(
        100 * b["bound_ms"] / 0.1)
    assert catalog.reader("pairhmm_matrix_roofline")(run) is None


class _E:
    def __init__(self, name, lo, hi, device):
        self._n, self._lo, self._hi, self.device = name, lo, hi, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._lo

    def duration_ns(self):
        return self._hi - self._lo


def test_read_trace_charges_plans_and_labels_gaps():
    ev = [_E("window", 0, 1000, False), _E("call:HaplotypeCaller", 0, 1000, False),
          _E("stage:assembly", 0, 300, False), _E("stage:genotype", 600, 900, False),
          _E("pairhmm::plan_scan(int)", 300, 340, True),
          _E("void pairhmm_fwd_kernel<false>(Args)", 340, 400, True),
          _E("Memcpy HtoD", 390, 450, True),
          _E("pairhmm::plan_count(int)", 700, 710, True),
          _E("void pairhmm_matrix_kernel(Args)", 710, 760, True),
          _E("stage:assembly", 0, 0, True),  # a range's copy on the device
          _E("bench:capture", 765, 790, False), _E("bench:capture", 770, 780, True),
          _E("void index_elementwise_kernel", 771, 779, True)]  # the harness's gather
    out = roofline.read_trace(ev, (0, 1000), lambda e: e.device)
    assert out["kernel_ns"] == {"pairhmm_fwd": 100, "pairhmm_matrix": 60}
    assert out["busy_ns"] == 150 + 60  # 300-450 and 700-760, overlaps once
    idle = dict(out["idle"])
    assert idle == {"stage:assembly": 300, "call:HaplotypeCaller": 250, "stage:genotype": 240}
    assert sum(idle.values()) + out["busy_ns"] == 1000
    assert out["harness_ns"] == 8 and "void index_elementwise_kernel" not in dict(out["device_ops"])


def test_card_time_per_kread():
    # 4 calls of 5,300 reads whose launches took 2.12 ms on the card in all
    run = _run([13.0] * 4, [5300] * 4, window_s=52.0)
    run.card_ms = 2.12
    assert catalog.reader("card_ms_per_kread")(run) == pytest.approx(2.12 / 21.2)
    run.card_ms = None  # a run off the card, or with no launch
    assert catalog.reader("card_ms_per_kread")(run) is None
