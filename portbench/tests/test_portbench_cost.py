"""The least-work functions against counts made by hand for one level of
each configuration."""

import pytest

from portbench.cost import gain_train, learn_bank, roundtrip, shapes

D2 = {"shape": [1000, 1000], "taps": 10, "mode": "periodic", "level": 1, "dtype": "float32"}
D1 = {"shape": [1000000], "taps": 10, "mode": "periodic", "level": 1, "dtype": "float32"}


def test_halving():
    assert [b for _, b in shapes.levels([1000, 1000], 10, "periodic", 5)] == [
        (504, 504), (256, 256), (132, 132), (70, 70), (39, 39)]
    assert shapes.halve(1000000, 10, "periodic") == 500004
    assert shapes.halve(1001, 10, "periodization") == 501


def test_2d_level_by_hand():
    # analysis: along W 2 bands of 1000 x 504, along H 4 bands of 504 x 504, 10 products each
    assert shapes.analysis_macs((1000, 1000), (504, 504), 10) == 2 * 1000 * 504 * 10 + 4 * 504 * 504 * 10
    # synthesis: along H 2 outputs of 1000 x 504, along W one of 1000 x 1000, 10 products each
    assert shapes.synthesis_macs((1000, 1000), (504, 504), 10) == 2 * 1000 * 504 * 10 + 1000 * 1000 * 10
    nbytes, ops = roundtrip.cost(D2, {"batch": 1})
    assert nbytes == 4 * 2 * (1000 * 1000 + 4 * 504 * 504)
    assert ops == 2 * (20240640 + 20080000)


def test_1d_level_by_hand():
    assert shapes.analysis_macs((1000000,), (500004,), 10) == 2 * 500004 * 10
    assert shapes.synthesis_macs((1000000,), (500004,), 10) == 1000000 * 10
    nbytes, ops = roundtrip.cost(D1, {"batch": 3})
    assert nbytes == 3 * 4 * 2 * (1000000 + 2 * 500004)
    assert ops == 3 * 2 * (10000080 + 10000000)


def test_training_counts_by_hand():
    n, bands, details = 1000 * 1000, 4 * 504 * 504, 3 * 504 * 504
    nbytes, ops = gain_train.cost(D2, {"batch": 2})
    assert nbytes == 2 * 4 * (11 * n + 4 * bands + 4 * details)
    assert ops == 2 * 4 * (20240640 + 20080000)
    n, bands, details = 1000000, 2 * 500004, 500004
    nbytes, ops = learn_bank.cost(D1, {"batch": 2})
    assert nbytes == 2 * 4 * (7 * n + 4 * bands + 2 * details)
    assert ops == 2 * 2 * (3 * 10000080 + 2 * 10000000)


@pytest.mark.parametrize("mode", ["periodic", "periodization"])
def test_the_count_does_not_depend_on_the_route(mode):
    # a level split in two half-batches costs what the whole batch does
    config = dict(D2, level=5, mode=mode)
    whole = roundtrip.cost(config, {"batch": 8})
    half = roundtrip.cost(config, {"batch": 4})
    assert whole == (2 * half[0], 2 * half[1])
