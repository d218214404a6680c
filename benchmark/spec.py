"""`BENCHMARK.json` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, call, content
kind or metric sits in a file of its own under the benchmark's folder:

    configs/<config>.json     the configuration (shape, pool, content)
    traffic/<traffic>.json    the traffic mix (the call it drives)
    calls/<call>.py           what a traffic mix's call drives
    content/<kind>.py         how a configuration's pool is made
    metrics/<metric>.py       one reader a metric, `read(ctx)`

The harness keeps no list of them: it loads what the cell's names point at.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


class Spec:
    def __init__(self, root: str, folder: str = HERE):
        self.root, self.folder = root, folder
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.folder, kind, f"{name}.json")) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def module(self, kind: str, name: str):
        """The module `<folder>/<kind>/<name>.py`, loaded by its path (a
        metric's name may hold dots)."""
        key = f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_")
        if key in sys.modules:
            return sys.modules[key]
        path = os.path.join(self.folder, kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or not os.path.exists(path):
            raise FileNotFoundError(f"no {kind} module {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer ones (traced)."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]
