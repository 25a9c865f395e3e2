"""The controls come out as not correct: the reference one precision
below the configuration's, in the program's place."""

import pytest
import torch

from portbench import control, harness

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["bpr-amazon.serve-k1",
                                  "bpr-amazon.serve-exact",
                                  "bpr-amazon.batch-k10"])
def test_fp8_tables_fail_a_served_cell(tiny, name):
    cell = tiny(name)
    ok, _ = harness.judge(control.readings(cell, 21, 0.3, "program", CPU),
                          cell["limits"])
    assert ok
    bad, checks = harness.judge(
        control.readings(cell, 21, 0.3, "control", CPU), cell["limits"])
    assert not bad
    assert checks["score_err"]["value"] > 10 * cell["limits"]["score_err"]


@pytest.mark.card
def test_tf32_fails_the_training_cell(card, tiny):
    cell = tiny("dlrm-kaggle.train-zipf")
    cell["traffic"].update(batch=8192)
    ok, _ = harness.judge(control.readings(cell, 23, 0.3, "program", card),
                          cell["limits"])
    assert ok
    bad, _ = harness.judge(control.readings(cell, 23, 0.3, "control", card),
                           cell["limits"])
    assert not bad
