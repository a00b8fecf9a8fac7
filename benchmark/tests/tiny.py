"""Cells of the benchmark cut to a size the CPU runs in seconds: the real
cells' files with a narrow model and small inputs; everything else (the
entries, the generator, the checks, the limits) as committed."""

from __future__ import annotations

import copy

from benchmark.harness.spec import Cell

TINY_MODEL = {"embed_dim": 24, "depths": [2, 2], "num_heads": [2, 2],
              "hier_win_ratios": [0.5, 1, 2]}
TINY_TRAFFIC = {
    "frame1080.bf16": {"sizes": [[40, 56]], "band_rows": 12, "dtype": "float32"},
    "photos.bf16": {"sizes": [[20, 24], [32, 32], [40, 72]], "tile": 32, "overlap": 16,
                    "dtype": "float32", "check": {"sample": 2, "within": 6}},
    "train.f32": {"lr_size": 16, "pool": 3},
}


def tiny_cell(name: str) -> Cell:
    cell = Cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(TINY_MODEL)
    if "gan" in cell.config:
        cell.config["gan"]["ndf"] = 8
    traffic = [k for k in TINY_TRAFFIC if name.endswith(k)][0]
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC[traffic])
    return cell
