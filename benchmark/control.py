"""The readings that a cell's correctness limits are set from, on several
seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --fault half_batch
    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --precision float64
    python3 benchmark/control.py --workload <cell> --seeds 1,...,12 --program --seconds 1

By default the plain reference is put in the program's place at the
mix's ``control`` precision (the precision one below the cell's: fp8 for
bfloat16, bfloat16 for float32 with TF32 convolutions) and, for a
training cell, with ``--fault half_batch`` planted (each checked step's
loss over half its batch), on the inputs and samples a run of that seed
compares; a control or a fault has to exceed at least one limit.
``--precision float64`` puts the reference in float64 in its place: how
far the float32 reference itself lies from exact.  ``--program`` reads
the program's own numbers instead: a whole run of each seed, with a
window of ``--seconds``, as ``run.py`` makes it.  Prints one JSON line per
seed with each number beside the cell's limit.  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(cell, seed: int, precision: str = "", fault: str = "",
            device: str = "cuda") -> dict:
    from benchmark.harness.check import verdict
    from benchmark.harness.spec import load_module
    from benchmark.reference.precision import exact

    precision = precision or cell.traffic["control"]
    entry = load_module("entries", cell.traffic["entry"]).Entry(cell, seed, device)
    entry.inputs()
    with exact():
        numbers = entry.control(precision, cell.limits, fault)
    return {"seed": seed, "precision": precision, "fault": fault,
            "correct": verdict(numbers),
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in numbers}}


def program(cell, seed: int, seconds: float) -> dict:
    from benchmark.run import run

    res = run(cell.name, seed, seconds, False, cell=cell)
    return {"seed": seed, "program": True, "correct": res["correct"],
            "checks": res["checks"], "metrics": res["metrics"]}


def main(argv=None) -> int:
    from benchmark.harness.spec import Cell
    from benchmark.run import _cache_dirs

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--precision", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--program", action="store_true")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    _cache_dirs()
    cell = Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        out = (program(cell, seed, args.seconds) if args.program
               else control(cell, seed, args.precision, args.fault))
        out["seconds"] = time.monotonic() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
