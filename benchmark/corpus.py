"""The real-photo corpus as pixels: the pinned `.nice` files decoded by
the reference, cached in the benchmark's own directory.

`corpus.json` pins every file of the corpus by SHA-256; a run refuses to
start if one differs, so the images under the benchmark cannot change
without a change to the benchmark.  The reference decoder (a serial Python
loop) turns each file into pixels once, in subprocesses spread over the
cores; the pixels are kept as `.cache/<name>-<sha256[:16]>.npy` beside this
file, so only a checkout's first run pays for it.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from benchmark import jobs

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")


def pins() -> dict:
    with open(os.path.join(HERE, "corpus.json")) as f:
        return json.load(f)


def verify(root: str) -> dict[str, str]:
    """{name: path} of every pinned file; raise where one is missing or
    its SHA-256 differs from the pin."""
    p = pins()
    paths = {}
    for name, sha in p["sha256"].items():
        path = os.path.join(root, p["dir"], f"{name}.nice")
        with open(path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != sha:
            raise RuntimeError(f"corpus file {path} has SHA-256 {got}, pinned {sha}: refusing to run")
        paths[name] = path
    return paths


def load(root: str, names) -> dict[str, np.ndarray]:
    """{name: (H, W, 3) uint8} for the named corpus images, decoded by the
    reference at most once a checkout."""
    paths = verify(root)
    sha = pins()["sha256"]
    os.makedirs(CACHE, exist_ok=True)
    want = {n: os.path.join(CACHE, f"{n}-{sha[n][:16]}.npy") for n in sorted(set(names))}
    missing = [n for n, dst in want.items() if not os.path.exists(dst)]
    datas = []
    for n in missing:
        with open(paths[n], "rb") as f:
            datas.append(f.read())
    for n, img in zip(missing, jobs.decode(datas, root)):
        tmp = f"{want[n]}.{os.getpid()}.part"
        with open(tmp, "wb") as f:
            np.save(f, img)
        os.replace(tmp, want[n])  # a concurrent reader never sees half a file
    return {n: np.load(dst) for n, dst in want.items()}
