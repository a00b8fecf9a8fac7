"""The port's HiT-SIR-Pro against the reference's own goldens.

``tests/golden/hit_sir_*.npz`` hold outputs the reference PyTorch model
recorded itself (tools/make_goldens.py).  The two small fusion cases carry
their state dicts (``sd__*``), loaded strictly; the flagship case carries
its manifest, from which the port's own ``synth_state_dict`` rebuilds the
weights.  Bars as in test_model_parity.py: max abs < 1e-3 and rms < 5e-5
for the small cases, < 2e-3 and < 2e-4 for the full-depth flagship.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_model_parity import CASES

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"


def _run(cfg, state, x_nchw):
    from sisr_tpu_torch.models.hit_sir_pro import HiTSIR

    model = HiTSIR(**cfg).eval()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    with torch.inference_mode():
        y = model(torch.from_numpy(x_nchw.transpose(0, 2, 3, 1).copy()))
    return y.numpy().transpose(0, 3, 1, 2)


def _errs(got, ref):
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    return float(err.max()), float(np.sqrt(np.mean(err ** 2)))


@pytest.mark.parametrize("name", ["tiny_full", "stage_hier"])
def test_forward_matches_reference_golden(name):
    blob = np.load(GOLDEN / f"hit_sir_{name}.npz")
    state = {k[len("sd__"):]: blob[k] for k in blob.files if k.startswith("sd__")}
    max_err, rms = _errs(_run(CASES[name], state, blob["input"]), blob["output"])
    assert max_err < 1e-3, f"max abs err {max_err:.3e}"
    assert rms < 5e-5, f"rms err {rms:.3e}"


def test_flagship_matches_reference_golden():
    from sisr_tpu_torch.models.hit_sir_pro import flagship_config
    from sisr_tpu_torch.utils.param_synth import synth_state_dict

    blob = np.load(GOLDEN / "hit_sir_flagship.npz")
    manifest = [(str(n), tuple(int(v) for v in s.split(",")))
                for n, s in zip(blob["manifest_names"], blob["manifest_shapes"])]
    max_err, rms = _errs(_run(flagship_config(), synth_state_dict(manifest), blob["input"]),
                         blob["output"])
    assert max_err < 2e-3, f"max abs err {max_err:.3e}"
    assert rms < 2e-4, f"rms err {rms:.3e}"
