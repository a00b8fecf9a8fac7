"""On the card only (marked ``cuda``; each skips without one): one short
run of the photo cell at its real size is correct, and its control, the
reference in fp8 in the program's place, is not, on three seeds.

    python -m pytest --noconftest benchmark/tests/test_bench_card.py -m cuda -q
"""

import pytest

import benchmark.run as bench_run
from benchmark.control import control
from benchmark.harness.spec import Cell

CELL = "hitsir_pro.photos.bf16"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_photo_cell_is_correct_on_the_card(card):
    res = bench_run.run(CELL, 2**31 + 4242, 3.0, False)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_photo_cell_control_is_not_correct_on_the_card(card, seed):
    assert control(Cell(CELL), seed, "fp8")["correct"] is False
