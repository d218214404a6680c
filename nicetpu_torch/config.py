"""Typed runtime configuration of the port (after `nicetpu.config`).

Format constants stay frozen in `format/constants.py`; this config only
covers runtime choices: backend, batching, worker threads.
Resolution order: explicit kwargs > environment (NICETPU_*) > defaults.

Backends:
    "cuda"    the CUDA kernels on the card (the default); raises where CUDA
              is absent: nothing answers in its place
    "cpu"     the kernels' plain PyTorch versions, by the caller's choice
    "native"  the port's host codec (`hostref`, C++ built by g++ at first use)
    "spec"    the port's numpy reference codec (`spec.codec`): needs no
              compiler; a serial Python decoder, for small images
There is no "auto": no backend answers for another.  `backend_target`
says where a backend runs and `resolve_device` checks a device; the api,
the schedulers, the CLI, the corpus and the sharded codec all ask them.
"""

from __future__ import annotations

import dataclasses
import os

import torch

BACKENDS = ("cuda", "cpu", "native", "spec")
HOST_CODECS = ("native", "spec")  # the backends served by a host codec


def resolve_device(device) -> torch.device:
    """The torch.device of "cuda" or "cpu"; "cuda" without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was requested but CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def backend_target(backend: str) -> torch.device | str:
    """Where a backend runs: the torch.device of "cuda" or "cpu", or the
    name of the host codec that serves it, "native" or "spec".  "cuda"
    without CUDA raises: no other backend answers in its place."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {BACKENDS}")
    return backend if backend in HOST_CODECS else resolve_device(backend)


@dataclasses.dataclass
class RuntimeConfig:
    backend: str = "cuda"  # cuda | cpu | native | spec
    batch_size: int = 8  # images per fused device pass (api.MAX_BATCH)
    workers: int = 4  # pipeline thread-pool width
    omp_threads: int = 0  # 0 = OpenMP default
    verbose: bool = False  # stage-timing prints (cli / pipeline)

    @classmethod
    def from_env(cls, **overrides) -> "RuntimeConfig":
        cfg = cls()
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"NICETPU_{f.name.upper()}")
            if env is not None:
                val = type(f.default)(env) if not isinstance(f.default, bool) else env.lower() in ("1", "true", "yes")
                setattr(cfg, f.name, val)
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config field {k!r}")
            setattr(cfg, k, v)
        return cfg

    def apply(self) -> None:
        """Apply process-level settings (call before the host codec's
        first use)."""
        if self.omp_threads:
            os.environ["OMP_NUM_THREADS"] = str(self.omp_threads)
