"""``python -m sisr_tpu_torch.lpips`` (the counterpart of the root
``test.py``) on the CPU: its value against JAX's ``LPIPSVgg`` on the same
weights (``jax_port.lpips_state_dict_from_jax``, written as the torch file
the script reads) within 1e-5 relative; the self-LPIPS is 0; a weights path
that does not exist raises; without ``--device cpu`` it asks for a card,
which this host lacks, and raises.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(((40, 48), (40, 48))):
        paths.append(root / f"im{i}.png")
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(paths[-1])
    return root, paths


def test_value_matches_jax_lpips(images):
    from sisr_tpu.models.vgg import LPIPSVgg as JaxLPIPS
    from sisr_tpu_torch.lpips import calculate_lpips, load_image
    from sisr_tpu_torch.models.jax_port import lpips_state_dict_from_jax

    root, (a, b) = images
    x, y = (jnp.asarray(load_image(str(p)))[None] for p in (a, b))
    jm = JaxLPIPS()
    variables = jm.init(jax.random.PRNGKey(3), x, y)
    want = float(jm.apply(variables, x, y)[0])
    weights = root / "lpips.pth"
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in lpips_state_dict_from_jax(variables).items()}, weights)
    got = calculate_lpips(str(a), str(b), str(weights), device="cpu")
    assert want != 0 and abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert calculate_lpips(str(a), None, str(weights), device="cpu") == 0.0


def test_missing_weights_and_no_card_raise(images):
    from sisr_tpu_torch.lpips import main

    _, (a, b) = images
    with pytest.raises(FileNotFoundError):
        main([str(a), str(b), "--weights", str(a) + ".missing", "--device", "cpu"])
    with pytest.raises(RuntimeError):
        main([str(a), str(b)])


def test_command_line_self_lpips_is_zero(images):
    _, (a, _) = images
    out = subprocess.run([sys.executable, "-m", "sisr_tpu_torch.lpips", str(a), "--device",
                          "cpu"], cwd=REPO, capture_output=True, text=True, check=True).stdout
    assert out.splitlines()[-1] == "lpips=0.0 (RANDOM-INIT vgg — relative values only)"
    gone = subprocess.run([sys.executable, "-m", "sisr_tpu_torch.lpips", str(a)], cwd=REPO,
                          capture_output=True, text=True)
    assert gone.returncode != 0 and "no CUDA card" in gone.stderr
