"""The control: the reference, put in the program's place, with the
configuration's lossless guarantee broken (the lowest bit of every byte
dropped before the reference's lossless coding, a near-lossless codec).
A cell's check has to judge it not correct.

    python3 -m benchmark.control --workload <name> --seeds <n> ... --calls <c>

Each seed runs the cell's set-up and a window of as many calls as a run of
the cell makes (`--calls`) with the control's answers (the call module's
`control`) served in place of the program's, and the same check as a run.  Prints one JSON line a seed (the numbers compared,
`correct`) and exits non-zero if any seed's check judged the control
correct.  Needs no card: the program is not run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from benchmark.run import run_cell
from benchmark.spec import Spec


class Control:
    """Serves the control's answer for each input, by the input's identity."""

    def __init__(self, call, pool, inputs, root):
        self.answers = call.control(pool, inputs, range(len(pool)), root)
        self.index = {id(x): k for k, x in enumerate(inputs)}

    def call(self, batch, stats):
        return [self.answers[self.index[id(x)]] for x in batch]

    def traced(self, batch, stats, marks):
        return self.call(batch, stats)


def run(spec: Spec, workload: str, seed: int, calls: int, device: str) -> dict:
    return run_cell(spec, workload, seed, 3600.0, False, device=device, max_calls=calls,
                    make_program=lambda call, pool, inputs, dev: Control(call, pool, inputs, spec.root))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=300)
    args = ap.parse_args(argv)
    spec = Spec(os.getcwd())
    device = "cuda" if torch.cuda.is_available() else "cpu"
    judged_correct = 0
    for seed in args.seeds:
        r = run(spec, args.workload, seed, args.calls, device)
        judged_correct += r["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "checks": r["checks"]}), flush=True)
    return 1 if judged_correct else 0


if __name__ == "__main__":
    sys.exit(main())
