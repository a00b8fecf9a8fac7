"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

- ``configs/<config>.json``: the model's sizes as run (its ``file``);
- ``traffic/<traffic>.json``: the mix's parameters, read by ``traffic.py``;
- ``entries/<entry>.py``: the program's entry point that the mix drives
  (the mix names it under ``entry``);
- ``metrics/<metric>.py``: one reader per metric (``read(ctx)``); a
  metric split by cell, such as ``serve_mps.frame1080``, is read by its
  family's reader (``serve_mps.py``) where it has none of its own;
- ``limits/<cell>.json``: the limits of the cell's correctness numbers.

A later change adds a configuration, a mix, a metric or a cell by adding
such files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` as a module (names may hold dots);
    where there is none, that of the name without its last dotted part."""
    stem = name
    while not (BENCH / folder / f"{stem}.py").exists():
        if "." not in stem:
            raise FileNotFoundError(f"no {folder} module for {name!r} in {BENCH / folder}")
        stem = stem.rsplit(".", 1)[0]
    path = BENCH / folder / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{stem.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, mix and
    limits, and the metrics it reports."""

    def __init__(self, name: str, bench: Dict = None):
        bench = bench or read_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.name = name
        self.chips = int(w["chips"])
        self.config = read_json(ROOT / configs[w["config"]]["file"])
        self.traffic = read_json(BENCH / "traffic" / f"{w['traffic']}.json")
        limits = BENCH / "limits" / f"{name}.json"
        self.limits = read_json(limits) if limits.exists() else {}
        self.end_to_end: List[Dict] = [m for m in bench["end_to_end"] if _applies(m, name)]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer: List[Dict] = [m for m in bench["per_layer"]
                                      if m["moves"] in moves and _applies(m, name)]
