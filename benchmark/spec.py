"""The benchmark as data: a cell, its configuration, its traffic mix and its
per-layer readers, each found by the name that ``BENCHMARK.json`` gives.

* a configuration: the JSON file that its ``configs`` entry names;
* a traffic mix: ``<harness>/traffic/<traffic>.json``, whose ``kind``
  (``train`` or ``serve``) picks the general driver in ``kinds/``;
* a per-layer metric: ``<harness>/metrics/<metric name>.py``, a reader
  with ``read(ctx) -> float | None``;
* a cell's limits on the numbers that decide ``correct``:
  ``<harness>/limits/<cell name>.json``;

where ``<harness>`` is the first of the benchmark's ``paths``. Adding one of
each takes new files and new entries, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

REPO = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict            # the configuration's file
    traffic: Dict           # the traffic mix's file
    end_to_end: List[Dict]  # the end-to-end metrics this cell reports
    per_layer: List[Dict]   # the per-layer metrics this cell reports
    limits: Dict[str, float]
    readers: Dict[str, Callable] = field(default_factory=dict)


def reader(path: Path) -> Callable:
    """The ``read`` of the metric reader at ``path``."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def find_cell(name: str, repo: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``<repo>/BENCHMARK.json``, with its files."""
    repo = Path(repo or REPO)
    spec = load_json(repo / "BENCHMARK.json")
    harness = repo / spec["paths"][0]
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; there are {sorted(cells)}")
    wl = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    cell = Cell(name=name, chips=wl["chips"],
                config=load_json(repo / entry["file"]),
                traffic=load_json(harness / "traffic"
                                  / f"{wl['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=load_json(harness / "limits" / f"{name}.json"))
    cell.readers = {m["name"]: reader(harness / "metrics"
                                       / f"{m['name']}.py")
                    for m in per_layer}
    return cell
