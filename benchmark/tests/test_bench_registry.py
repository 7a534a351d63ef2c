"""The registry finds every cell's parts by name, and a new cell is only new
files plus an entry in BENCHMARK.json."""

import json
import shutil

import pytest

from csbench import registry
from small import CELLS

SPEC = registry.load_spec()


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_parts(name):
    cell = registry.cell(SPEC, name)
    assert callable(cell["plugins"]["kind"].run) and callable(cell["plugins"]["kind"].control)
    assert callable(cell["plugins"]["absorber"].program)
    if "core" in cell["params"]:
        assert callable(cell["plugins"]["core"].reference)
    assert {"catalog", "atmosphere", "check"} <= set(cell["params"])
    assert set(cell["params"]["check"]["limits"]) and cell["end_to_end"] and cell["per_layer"]
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(registry.reader(m["name"]).read)
    for m in cell["per_layer"]:
        assert m["moves"] in reported


def test_every_metric_file_is_named_and_every_name_has_a_file():
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    files = {p.name[:-3] for p in (registry.BENCH / "metrics").glob("*.py")}
    assert names == files


def test_config_files_hold_their_entries():
    for conf in SPEC["configs"]:
        data = json.loads((registry.ROOT / conf["file"]).read_text())
        assert data["name"] == conf["name"] and data["source"] == conf["source"]
        assert conf["file"].startswith(SPEC["paths"][0] + "/")


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    bench = tmp_path / registry.BENCH.name
    shutil.copytree(registry.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    traffic = json.loads((bench / "traffic" / "b1024.json").read_text())
    (bench / "traffic" / "b64.json").write_text(json.dumps(dict(traffic, columns=64)))
    (bench / "metrics" / "columns_seen.py").write_text(
        "def read(run):\n    return run.work.get('columns')\n")
    spec["workloads"].append({"name": "co2_h2o_sweep.b64", "config": "co2_h2o_sweep",
                              "traffic": "b64", "chips": 1, "why": "a small sweep"})
    spec["per_layer"].append({"name": "columns_seen", "unit": "columns", "better": "higher",
                              "source": "program_counter", "layer": "Device",
                              "moves": "column_steps_per_s",
                              "workloads": ["co2_h2o_sweep.b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = registry.cell(registry.load_spec(tmp_path), "co2_h2o_sweep.b64", root=tmp_path)
    assert cell["params"]["columns"] == 64 and cell["params"]["points"] == 4096
    assert "columns_seen" in [m["name"] for m in cell["per_layer"]]
    assert registry.reader("columns_seen", root=tmp_path).read(
        type("R", (), {"work": {"columns": 64}})()) == 64
    # the cells already there are unchanged
    assert registry.cell(registry.load_spec(tmp_path), "co2_h2o_sweep.b1024",
                         root=tmp_path)["params"] == registry.cell(SPEC, "co2_h2o_sweep.b1024")["params"]


def _copy(tmp_path):
    bench = tmp_path / registry.BENCH.name
    shutil.copytree(registry.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(SPEC))
    return bench


def test_a_new_core_kind_and_absorber_are_new_files(tmp_path):
    """A cell on a core, a traffic kind and an absorber that no cell used
    before: each is a file found by the name its parameters give."""
    bench = _copy(tmp_path)
    (bench / "cores" / "Discretized.py").write_text(
        "def linesum_states(params):\n    return 57\n\n"
        "def reference(params, sigma, Pe, Te, grid, idx, S0, dev, dtype, count_work=False):\n"
        "    return None, None, {}\n")
    (bench / "kinds" / "ahead.py").write_text(
        "def run(cell, seed, seconds, trace, dev, t_start):\n    return 'ran'\n\n"
        "def control(cell, seed, dev, dtype):\n    return {}\n")
    (bench / "absorbers" / "table.py").write_text(
        "def validate(params):\n    assert params['absorber']['nodes'] == 57\n\n"
        "def program(pars_concs, grid, device, params):\n    return None\n\n"
        "def reference(tab, params):\n    return None\n")
    traffic = json.loads((bench / "traffic" / "radau_radiate.json").read_text())
    traffic.update(kind="ahead", core={"name": "Discretized"},
                   absorber={"name": "table", "nodes": 57})
    (bench / "traffic" / "direct_ahead.json").write_text(json.dumps(traffic))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "co2_column.direct_ahead", "config": "co2_column",
                              "traffic": "direct_ahead", "chips": 1, "why": "a new path"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = registry.cell(registry.load_spec(tmp_path), "co2_column.direct_ahead", root=tmp_path)
    assert cell["plugins"]["core"].linesum_states(cell["params"]) == 57
    assert cell["plugins"]["kind"].run(cell, 1, 1.0, False, "cpu", 0.0) == "ran"
    assert cell["params"]["absorber"] == {"name": "table", "nodes": 57}


@pytest.mark.parametrize("change,message", [
    ({"core": {"name": "NoSuchCore"}}, "cores/NoSuchCore.py"),
    ({"kind": "no_such_kind"}, "kinds/no_such_kind.py"),
    ({"absorber": {"name": "no_such_absorber"}}, "absorbers/no_such_absorber.py"),
    ({"core": {"name": "Radau", "tol": 1e-5, "max_steps": 10}}, "no reference for"),
    ({"absorber": {"name": "lines", "shape": "phco2"}}, "no reference for"),
])
def test_a_part_without_its_file_or_reference_fails_at_load(tmp_path, change, message):
    """Before any set-up: a part whose file is missing, or an option that
    its reference does not follow."""
    bench = _copy(tmp_path)
    traffic = json.loads((bench / "traffic" / "radau_radiate.json").read_text())
    (bench / "traffic" / "radau_radiate.json").write_text(json.dumps(dict(traffic, **change)))
    with pytest.raises((KeyError, ValueError), match=message):
        registry.cell(registry.load_spec(tmp_path), "co2_column.radau_radiate", root=tmp_path)


def test_a_metric_without_its_reader_fails_at_load(tmp_path):
    _copy(tmp_path)
    spec = json.loads(json.dumps(SPEC))
    spec["per_layer"].append({"name": "no_such_metric", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "Device",
                              "moves": "columns_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(KeyError, match="metrics/no_such_metric.py"):
        registry.cell(registry.load_spec(tmp_path), "co2_column.radau_radiate", root=tmp_path)
