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
There is no "auto": no backend answers for another.
"""

from __future__ import annotations

import dataclasses
import os

BACKENDS = ("cuda", "cpu", "native", "spec")
HOST_CODECS = ("native", "spec")  # the backends served by a host codec


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
