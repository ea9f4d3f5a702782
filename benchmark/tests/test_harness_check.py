"""The check reads as not correct where it must: a whole run on the CPU,
each `aln` a process of its own, with the timed path broken underneath
(`plants.py`) in each way the `aln` cell can break, and with the plain
reference cut short in the program's place."""

import pytest

from benchmark import harness, spec


@pytest.mark.parametrize("plant", [None, "unchanged", "half_batch",
                                   "altered", "misordered",
                                   "ref_max_pops:24"])
def test_a_broken_timed_path_reads_not_correct(tiny, plant):
    cfg, t = tiny
    metrics = spec.Bench().metrics("chr1_aln_err2", False)
    r = harness.run_cell(cfg, t, metrics, 2**31 + 11, 30.0,
                         False, 0.0, card=False,
                         cli_extra=("--device", "cpu"), ref_workers=1,
                         plant=plant)
    assert r["correct"] is (plant is None), r["checks"]
    assert r["foreign"] == []
    assert r["metrics"]["aln_reads_per_s"]["value"] > 0
