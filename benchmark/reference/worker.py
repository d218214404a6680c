"""Run reference jobs in a plain subprocess, through its pipes.

    python3 -m benchmark.reference.worker < jobs.pickle > results.pickle

Standard input holds one pickled {"op": "encode" | "decode", "items": [...]}.
An encode takes (H, W, 3|4) uint8 arrays, drops the alpha plane as the
reference encoder does, and gives `.nice` bytes; a decode takes `.nice`
bytes and gives (H, W, 3) uint8 arrays.  Standard output receives the
pickled list of results, in order.  Nothing is written to disk.  Imports
numpy and the reference alone.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np

from benchmark.reference import codec


def run_job(op: str, item):
    if op == "encode":
        return codec.encode(np.ascontiguousarray(item[:, :, :3]))
    if op == "decode":
        return codec.decode(item)
    raise ValueError(f"unknown reference job {op!r}")


def main() -> int:
    job = pickle.load(sys.stdin.buffer)
    out = [run_job(job["op"], item) for item in job["items"]]
    pickle.dump(out, sys.stdout.buffer, protocol=pickle.HIGHEST_PROTOCOL)
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
