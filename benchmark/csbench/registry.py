"""Find a cell's parts by name: its configuration's file (named in
``BENCHMARK.json``), its traffic mix (``traffic/<traffic>.json``), the
traffic kind, flux core and absorber its parameters name (``kinds/<kind>.py``,
``cores/<core>.py``, ``absorbers/<absorber>.py``), and a reader for each
metric it reports (``metrics/<metric>.py``).

A cell, configuration, traffic mix, traffic kind, core, absorber or metric
is added by adding its file and its entry in ``BENCHMARK.json``; nothing
here names one. Every part is found, and checked by its own ``validate``
where it has one, when the cell is loaded: before set-up, not after the
window.
"""

from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "BENCH", "PLUGINS", "load_spec", "cell", "reader", "plugin", "merge"]

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

# the parameter that names a part -> the folder of its files
PLUGINS = {"kind": "kinds", "core": "cores", "absorber": "absorbers"}


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys laid on it (nested dicts merged)."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _module(path: Path, tag: str):
    if not path.is_file():
        raise KeyError(f"no file {path.relative_to(path.parents[1])} for {tag}")
    spec = importlib.util.spec_from_file_location(
        "bench_" + tag.replace(".", "_").replace("/", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plugin(folder: str, name: str, root: Path = ROOT):
    """The module of ``<folder>/<name>.py``."""
    return _module(Path(root) / BENCH.name / folder / f"{name}.py", f"{folder}/{name}")


def reader(name: str, root: Path = ROOT):
    """The module of ``metrics/<name>.py``; its ``read(run)`` gives the
    metric's value, or None where the run holds nothing to read."""
    return plugin("metrics", name, root)


def _applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload``: its entry, its configuration's entry, the
    parameters (the configuration's file with the traffic mix laid over it),
    the modules of the parts they name (``plugins``: kind, core, absorber)
    and the end-to-end and per-layer metric entries it reports."""
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((Path(root) / conf["file"]).read_text())
    traffic = json.loads((Path(root) / BENCH.name / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    params = merge(config, traffic)
    if "kind" not in params:
        raise KeyError(f"the traffic {w['traffic']!r} names no kind")
    plugins = {}
    for key, folder in PLUGINS.items():
        if key in params:
            name = params[key] if isinstance(params[key], str) else params[key]["name"]
            plugins[key] = plugin(folder, name, root)
    for mod in plugins.values():
        if hasattr(mod, "validate"):
            mod.validate(params)
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, workload, names)]
    for m in e2e + layer:
        reader(m["name"], root)
    return dict(workload=w, config=conf, params=params, plugins=plugins, end_to_end=e2e,
                per_layer=layer)
