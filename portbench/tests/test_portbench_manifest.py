"""``BENCHMARK.json`` against the benchmark's contract: its keys, names and
units, every cell's files found by name, every per-layer metric's
``moves`` reported where it is read, the bounds, the run length."""

import importlib
import json
import math
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WORK = {w["name"]: w for w in BENCH["workloads"]}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert cmd[1] == "portbench/run.py" and (ROOT / cmd[1]).is_file()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_full_check_fits_at_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entry_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        for cell in m.get("workloads", []):
            assert cell in WORK
    for m in BENCH["end_to_end"]:
        allowed = {"name", "unit", "better", "bound", "source", "workloads"}
        assert set(m) <= allowed and m["source"] in ("host_clock",
                                                     "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        allowed = {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}
        assert set(m) <= allowed and line(m["layer"])
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len(WORK) == len(BENCH["workloads"])


def test_counts_of_entries():
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * len(WORK)))
    assert len({(w["config"], w["traffic"]) for w in WORK.values()}) == len(
        WORK)
    used = {w["config"] for w in WORK.values()}
    assert used == {c["name"] for c in BENCH["configs"]}


def _reports(cell):
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])}
    layer = {m["name"] for m in BENCH["per_layer"]
             if cell in m.get("workloads", [cell])}
    return e2e, layer


@pytest.mark.parametrize("cell", sorted(WORK))
def test_every_cell_reports_enough(cell):
    e2e, layer = _reports(cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_in_each_cell(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", list(WORK)):
        assert metric["moves"] in _reports(cell)[0], cell


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_shares_are_percent_and_rooflines_beside_an_mfu(metric):
    name = metric["name"]
    if "roofline" in name:
        assert name.split(".")[0].endswith("_roofline")
        assert metric["unit"] == "%"
        mfu = [m for m in BENCH["per_layer"] if "mfu" in m["name"]
               and m["moves"] == metric["moves"]]
        for cell in metric["workloads"]:
            assert any(cell in m["workloads"] for m in mfu), cell
    if "mfu" in name or "share" in name:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", sorted(WORK))
def test_every_cells_files_are_found_by_name(cell):
    w = WORK[cell]
    conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert (ROOT / conf["file"]).is_file()
    assert conf["file"] == f"portbench/configs/{w['config']}.json"
    cfile = json.loads((ROOT / conf["file"]).read_text())
    assert cfile["name"] == w["config"] and cfile["reduced"] == conf["reduced"]
    for key in cfile["reduced"]:
        assert key in cfile
        assert not re.search(r"(_dim|_rank|_size|heads|experts_per_tok)$",
                             key), key
    traffic = json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())
    assert (PB / "drivers" / f"{traffic['kind']}.py").is_file()
    assert importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    assert importlib.import_module(f"portbench.reference.{cfile['family']}")
    limits = json.loads((PB / "limits" / f"{cell}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_reader_is_found_by_name(metric):
    from portbench import run
    read = run._reader(metric["name"])
    assert read({}) is None


@pytest.mark.parametrize("reader", sorted(p.stem for p in
                                          (PB / "metrics").glob("*.py")))
def test_every_reader_file_reads_nothing_from_nothing(reader):
    """Readers wait for cells too (an open loop's): each loads by its name
    and, with nothing to read, returns nothing."""
    from portbench import run
    assert run._reader(reader)({}) is None
