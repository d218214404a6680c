"""Spread reference jobs over the host's cores in plain subprocesses.

No `multiprocessing` pool: its locks are POSIX semaphores, files in
`/dev/shm`.  Each subprocess runs `benchmark.reference.worker` on a share
of the jobs, with one thread for numpy; the jobs are shared out largest
first to the least loaded worker.  Inputs and results travel through the
subprocesses' pipes (one thread of this process feeds and drains each).
The reference's encodes are kept in `.cache/ref/` beside this file, one
`.nice` file an input, named by the SHA-256 of the reference's sources and
of the input's shape and pixels: a run with a seed that an earlier run of
the checkout had reads them back instead of encoding again.
"""

from __future__ import annotations

import glob
import hashlib
import os
import pickle
import subprocess
import sys
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache", "ref")
ONE_THREAD = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}


def cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def run(op: str, items: list, weights: list[int], root: str, procs: int | None = None) -> list:
    """The reference's results of `op` ("encode" or "decode") on each
    item, in order, over at most `procs` subprocesses (default: every core);
    raise if one fails."""
    if not items:
        return []
    n = max(1, min(len(items), procs or cores()))
    shares: list[list[int]] = [[] for _ in range(n)]
    loads = [0] * n
    for i in sorted(range(len(items)), key=lambda i: -weights[i]):
        k = loads.index(min(loads))
        shares[k].append(i)
        loads[k] += weights[i]
    env = dict(os.environ, PYTHONPATH=root, **ONE_THREAD)
    results: list = [None] * len(items)
    errors: list[str] = []

    def work(share: list[int]) -> None:
        p = subprocess.Popen([sys.executable, "-m", "benchmark.reference.worker"], cwd=root, env=env,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        out, err = p.communicate(pickle.dumps({"op": op, "items": [items[i] for i in share]},
                                              protocol=pickle.HIGHEST_PROTOCOL))
        if p.returncode != 0:
            errors.append(err.decode(errors="replace")[-4000:])
            return
        for i, r in zip(share, pickle.loads(out)):
            results[i] = r

    threads = [threading.Thread(target=work, args=(s,)) for s in shares if s]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("a reference job failed:\n" + errors[0])
    return results


def _reference_sha() -> bytes:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(HERE, "reference", "*.py"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.digest()


def _key(image: np.ndarray, ref: bytes) -> str:
    h = hashlib.sha256(ref)
    h.update(repr((image.shape, str(image.dtype))).encode())
    h.update(np.ascontiguousarray(image))
    return h.hexdigest()


def encode(images: list[np.ndarray], root: str, procs: int | None = None) -> list[bytes]:
    """The reference encoder's `.nice` bytes of each image (alpha dropped),
    from the cache where an earlier run encoded the same pixels."""
    ref = _reference_sha()
    paths = [os.path.join(CACHE, f"{_key(im, ref)}.nice") for im in images]
    out: list = [None] * len(images)
    for i, path in enumerate(paths):
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[i] = f.read()
    missing = [i for i, d in enumerate(out) if d is None]
    todo = [images[i] for i in missing]
    if not todo:
        return out
    os.makedirs(CACHE, exist_ok=True)
    for i, data in zip(missing, run("encode", todo, [im.shape[0] * im.shape[1] for im in todo], root, procs)):
        tmp = f"{paths[i]}.{os.getpid()}.part"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, paths[i])  # a concurrent reader never sees half a file
        out[i] = data
    return out


def decode(datas: list[bytes], root: str, procs: int | None = None) -> list[np.ndarray]:
    """The reference decoder's pixels of each `.nice` stream."""
    return run("decode", datas, [len(d) for d in datas], root, procs)
