"""The readings the check's limits are set from, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 51 [--faults state_unchanged,half_left_out,answer_altered] \
        [--fault-seeds 4,5,6] [--fault-seconds 10] --out control.jsonl

For every seed, one run of the cell as run.py makes it: the program's
numbers compared (the lower readings) and, on the same served requests, the
control's: the reference with exact per-key order broken put in the
program's place (the upper readings). Then one run a planted fault
(portbench/faults.py) a fault seed, which has to come out not correct.
One JSON line a run, to --out and to standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import faults  # noqa: E402
from portbench import run as runner  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--fault-seconds", type=float, default=None,
                   help="the faults' window (default: --seconds)")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--keys", type=int, default=0,
                   help="a smaller fleet (rehearsal on the CPU)")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "a") as out:
        def line(d):
            s = json.dumps(d)
            print(s, flush=True)
            out.write(s + "\n")
            out.flush()

        over = ({"keys": a.keys, "capacity": a.keys + 1,
                 "pool_items": 1 << 20} if a.keys else None)

        def args(seed, seconds=a.seconds):
            return runner.parse(["--workload", a.workload, "--seed",
                                 str(seed), "--seconds", str(seconds)])

        for seed in [int(s) for s in a.seeds.split(",") if s]:
            r = runner.run(args(seed), a.device, over, control=True)
            line({"workload": a.workload, "seed": seed, "run": "program",
                  "correct": r["correct"], "attempted": r["attempted"],
                  "rate": r["attempted"] / a.seconds,
                  "checks": r["checks"], "control": r["control"]})
        for name in [f for f in a.faults.split(",") if f]:
            for seed in [int(s) for s in a.fault_seeds.split(",") if s]:
                with faults.FAULTS[name]():
                    r = runner.run(args(seed, a.fault_seconds or a.seconds),
                                   a.device, over)
                line({"workload": a.workload, "seed": seed, "run": name,
                      "correct": r["correct"], "attempted": r["attempted"],
                      "checks": r["checks"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
