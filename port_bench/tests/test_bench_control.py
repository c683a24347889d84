"""The control on the card, at the cell's own size: the program's own
lower-precision path (the single-scale bootstrap), and the plain
reference in fp8 put in its place, fail the cell's limit where the sound
run passes it.  Needs a CUDA
card (`-m card`); the cell's set-up takes about a minute."""

from __future__ import annotations

import pytest

from port_bench import control, harness


@pytest.mark.card
@pytest.mark.parametrize("workload", ["packed-s222", "pertoken-s222"])
def test_control_fails_the_limit(card, workload):
    cell = harness.Cell(workload)
    limit = cell.config["limits"]["max_logit_err"]
    got = control.readings(cell, 20261017, 10.0,
                           lower_types=("float8_e4m3fn",))
    assert got["sound"]["max_logit_err"] <= limit
    assert got["reference_float8_e4m3fn"]["max_logit_err"] > limit
    # the program's single-scale bootstrap fails: a reading above the
    # limit, or no reading at all
    assert not got["single_scale_boot"].get("max_logit_err", 1.0) <= limit
