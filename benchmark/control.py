"""The comparison's control, on the card at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--out <file.jsonl>]

For each seed, one run of the cell (set-up, a window of ``--seconds`` at
the cell's own load, the reference) judges two things on the same
window: the program's outputs, and the control's, which is the
reference's own answer with the canonical form broken (each value left
one modulus above its reduced form, wrapped at its width: the final
conditional subtraction skipped).  Prints one JSON line a seed with both
sets of compared numbers beside their limits; every control line must
exceed a limit, every program line none.  The benchmark's own runs
(``benchmark/run.py``) never run the control.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from benchmark import runner
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    failures = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = runner.run_cell(args.workload, seed, args.seconds, False,
                              controls=True, t0=t0)
        line = {"workload": args.workload, "seed": seed,
                "correct": out["correct"], "attempted": out["attempted"],
                "program": out["checks"], "control": out["control_checks"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "kind": out["device"]["kind"]}
        control_fails = any(v["value"] > v["limit"]
                            for v in out["control_checks"].values())
        failures += (not out["correct"]) + (not control_fails)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
