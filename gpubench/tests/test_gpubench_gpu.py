"""On the card: a short run of a cell is correct, and the control (the
port's own int8 path, turbo int8_conv) fails the cell's limit while the
system meets it. At the SD1.5 interactive cell's own size, one seed; the
limits' readings over a dozen seeds come from ``gpubench/calibrate.py``."""

import pytest

from gpubench import calibrate, harness

pytestmark = pytest.mark.gpu


def test_a_short_run_is_correct(cuda):
    line = harness.run_cell("sd-1.5.interactive", 2**31 + 3, 3.0, False)
    assert line["correct"] is True, line["compared"]


def test_the_control_fails_the_limit(cuda):
    r = calibrate.readings("sd-1.5.interactive", 2**31 + 4, True)
    assert r["system_correct"] is True, r["system"]
    assert r["control_correct"] is False, r["control"]
