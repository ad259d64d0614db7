"""Find what a cell of ``BENCHMARK.json`` needs, by name.

* a configuration ``<config>`` is ``configs/<config>.json``;
* a traffic mix ``<traffic>`` is ``traffic/<traffic>.json``, whose
  ``loop`` names the general generator that reads it, ``loops/<loop>.py``;
* a metric ``<name>`` is read by ``metrics/<name>.py`` (its ``read``),
  or, where that file is not there, by the file of the longest leading
  part of the name before a dot that has one: one reader serves
  ``device_idle_pct.build`` and ``device_idle_pct.query``;
* a configuration's ``reference`` names ``reference/<reference>.py``.

A later cell, configuration, mix or metric is a new file and a new entry,
never an edit of these.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def loop(name: str):
    return importlib.import_module(f"bpt_bench.loops.{name}")


def reference(name: str):
    return importlib.import_module(f"bpt_bench.reference.{name}")


def metric_path(name: str) -> Path:
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:k]) + ".py")
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{HERE / 'metrics'}")


def reader(name: str):
    """The ``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = metric_path(name)
    mod_name = "bpt_bench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, section: str) -> list[dict]:
    """The ``section`` (``end_to_end`` or ``per_layer``) metrics that
    ``cell_name`` reports: those listing it, and those listing no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]
