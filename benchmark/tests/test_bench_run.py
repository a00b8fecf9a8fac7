"""Whole runs of the tiny cells on the CPU (the look for a chip skipped):
the result line has exactly the contract's keys; a sound run is correct;
the controls (the reference one precision down in the program's place)
and faults planted in the program under the timed path come out not
correct, under the committed limits."""

import json

import pytest
import torch

import benchmark.run as bench_run
from benchmark.control import control
from benchmark.tests.tiny import tiny_cell

SERVE = ("hitsir_pro.frame1080.bf16", "hitsir_pro.photos.bf16")
TRAIN = ("hitsir_pro.train.f32", "hitsir_pro_gan.train.f32")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(name, trace=False, seed=2**31 + 77):
    # two seconds: the photo mix's tail needs two requests in the window
    return bench_run.run(name, seed, 2.0, trace, device="cpu", require_device=False,
                         cell=tiny_cell(name))


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_sound_run_is_correct_with_the_contract_keys(name):
    res = _run(name)
    assert set(res) == KEYS
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    cell = tiny_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.dumps(res)


def test_traced_run_adds_breakdown_and_device_times():
    res = _run("hitsir_pro.photos.bf16", trace=True)
    assert set(res) == KEYS | {"breakdown"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "tile_redundancy.photos" in res["metrics"]


def test_no_card_exits_without_a_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "hitsir_pro.photos.bf16", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_control_is_not_correct(name):
    for seed in (3, 2**31 + 5):
        out = control(tiny_cell(name), seed, device="cpu")
        assert out["precision"] == ("fp8" if name in SERVE else "bfloat16")
        assert out["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_float64_reference_in_the_programs_place_is_correct(name):
    out = control(tiny_cell(name), 11, "float64", device="cpu")
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_in_the_reference_is_not_correct(name):
    out = control(tiny_cell(name), 9, "float32", "half_batch", device="cpu")
    assert out["correct"] is False


def _roll_rows(call):
    def altered(self, img):
        return call(self, img).roll(1, 0)
    return altered


@pytest.mark.parametrize("name", SERVE)
def test_answer_altered_where_produced_is_not_correct(name, monkeypatch):
    from sisr_tpu_torch.parallel import tiling

    cls = tiling.BandedHeadSR if "frame" in name else tiling.TiledSR
    monkeypatch.setattr(cls, "__call__", _roll_rows(cls.__call__))
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_leaves_the_state_unchanged_is_not_correct(name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = _run(name)
    assert res["correct"] is False
    assert res["checks"]["change_gap.g"]["value"] > 0.5


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out_is_not_correct(name, monkeypatch):
    from sisr_tpu_torch.train import train_state

    for maker in ("make_train_step", "make_gan_train_step"):
        make = getattr(train_state, maker)

        def halved(*args, _make=make, **kwargs):
            step = _make(*args, **kwargs)
            return lambda lr, hr, gen=None: step(lr[:len(lr) // 2], hr[:len(hr) // 2], gen)

        monkeypatch.setattr(train_state, maker, halved)
    assert _run(name)["correct"] is False
