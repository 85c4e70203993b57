"""The control of a cell: the reference in TF32, put in the program's place.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's data, answers every query of the
configuration once with the reference's top k computed in TF32 (the
precision just below the float32 that the configurations state), and
judges those answers as a run's are judged. It prints one JSON line a
seed with every check's value and limit: the control has to fail at least
one of them. In the ingest cell the corpus is `--flushes` flushes of the
mix's pool, as many as a window flushes. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, judge  # noqa: E402
from portbench.data import LatentData  # noqa: E402


def readings(root: Path, name: str, seed: int, device,
             flushes: int = 6) -> list:
    """The checks of the control's answers for one seed."""
    cell = harness.Cell.find(root, name)
    cfg, tr = cell.config, cell.traffic
    data = LatentData(dict(cfg["data"], dim=cfg["dim"]), seed, device)
    n = (int(tr["rows_per_flush"]) * flushes if "rows_per_flush" in tr
         else int(cfg["rows"]))
    rows, queries = data.rows(n), data.queries(int(cfg["queries"]))
    reference = cell.module("reference", cfg["reference"])
    k = int(cfg["search"]["k"])
    ids, scores = reference.control_topk(rows, queries, k, device)
    answers = judge.Answers(
        np.arange(queries.shape[0], dtype=np.int64), ids, scores)
    return judge.judge(answers, rows, queries, k, cfg["limits"], reference,
                       device)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--flushes", type=int, default=6)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    root = Path(__file__).resolve().parent.parent
    for seed in args.seeds:
        checks = readings(root, args.workload, seed, args.device,
                          args.flushes)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fails": [c.name for c in checks if not c.holds],
                          "checks": {c.name: [c.value, c.limit]
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
