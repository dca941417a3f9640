"""The benchmark's parts, found by name: BENCHMARK.json at the checkout's
root, and one file each per configuration (`configs/<name>.json`), cell
(`workloads/<name>.json`, its traffic mix: walkers, schedule, start and the
limits of its comparison) and metric (`metrics/<name>.py`, a `read(run)`
that returns the metric's value or None)."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]      # pigsbench/
REPO = ROOT.parent                               # the checkout
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def _file(root: Path, folder: str, name: str, suffix: str) -> Path:
    if not NAME_RE.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    path = root / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    return path


def names(folder: str, suffix: str, root: Path = ROOT) -> list:
    """The names of the files of one kind, sorted."""
    return sorted(p.name[:-len(suffix)] for p in (root / folder).iterdir()
                  if p.name.endswith(suffix) and p.is_file())


def workload(name: str, root: Path = ROOT) -> dict:
    return json.loads(_file(root, "workloads", name, ".json").read_text())


def config(name: str, root: Path = ROOT) -> dict:
    return json.loads(_file(root, "configs", name, ".json").read_text())


def metric_reader(name: str, root: Path = ROOT):
    """The `read(run)` of metrics/<name>.py."""
    path = _file(root, "metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "pigsbench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The entries of bench[kind] ('end_to_end' or 'per_layer') that the
    cell reports: those that list it under `workloads`, and those without
    the key."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
