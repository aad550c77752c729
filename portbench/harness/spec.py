"""A cell resolved by name from BENCHMARK.json and the benchmark's data
files: `configs/<config>.json` (the scene as run), `traffic/<traffic>.json`
(which mix drives the window, with its parameters), `cells/<cell>.json`
(the cell's own settings: the traced sub-window, the compared numbers'
limits), `mixes/<mix>.py` (the code that drives one kind of traffic) and
`metrics/<metric>.py` (one per-layer metric's reader). Adding a cell adds
files and entries; it edits none."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from its file (metric readers' names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def mix(self) -> str:
        return self.traffic["mix"]

    def mix_module(self):
        return load_module(os.path.join(BENCH_DIR, "mixes",
                                        self.mix + ".py"),
                           "portbench_mix_" + self.mix)

    def readers(self) -> Dict[str, Callable]:
        """name -> the `read(records)` of metrics/<name>.py, for every
        per-layer metric of this cell."""
        return {m["name"]: load_module(
            os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"),
            "portbench_metric_" + m["name"].replace(".", "_")).read
            for m in self.per_layer}


def _applies(metric: dict, cell: str, reported: Optional[set] = None
             ) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, bench_path: Optional[str] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(wl)})")
    w = wl[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(os.path.join(ROOT, cfg["file"])),
                traffic=_json(os.path.join(BENCH_DIR, "traffic",
                                           w["traffic"] + ".json")),
                settings=_json(os.path.join(BENCH_DIR, "cells",
                                            name + ".json")),
                end_to_end=e2e, per_layer=layer)
