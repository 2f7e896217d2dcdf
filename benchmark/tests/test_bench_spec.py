"""BENCHMARK.json against the benchmark's contract, and the harness
finding each piece by name: configurations, traffic mixes, kinds of work
and per-layer readers."""

import json
import os
import re

import pytest

from nbench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_shape_of_the_file(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    # a full check with 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200
    names = [e["name"] for sec in ENTRY_KEYS for e in bench[sec]]
    assert len(names) == len(set(names))
    for sec, keys in ENTRY_KEYS.items():
        for e in bench[sec]:
            extra = {"workloads"} if sec in ("end_to_end", "per_layer") \
                else set()
            assert keys <= set(e) <= keys | extra, e
            assert NAME.match(e["name"]), e["name"]
    assert 1 <= cells <= 24
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_entries(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        # every cell it lists reports the end-to-end metric it moves
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in harness.Spec()
                                  .end_to_end(w)}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_cell_reports_what_it_must(bench):
    spec = harness.Spec()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(w["name"])


def test_pieces_are_found_by_name(bench):
    """Each cell's configuration and traffic file, the traffic's kind and
    rate metric, its check's limit, and every per-layer reader, whose
    read() gives None where the run has nothing for it to read."""
    spec = harness.Spec()
    for w in bench["workloads"]:
        cfg = spec.config(w["config"])
        t = spec.traffic(w["traffic"])
        assert callable(spec.kind(t["kind"]))
        assert t["rate_metric"] in {m["name"] for m in
                                    spec.end_to_end(w["name"])}
        assert 0 < cfg["limits"][t["check"]]
        ctx = {"cfg": cfg, "traffic": t, "trace": None, "traced": None,
               "peaks": None, "need": {}, "notes": [],
               "main": {"units": 0, "window_s": 1.0, "sent": [],
                        "host_s": []}}
        for m in spec.per_layer(w["name"]):
            assert spec.reader(m["name"])(ctx) is None, m["name"]
    with pytest.raises(KeyError):
        spec.workload("no_such_cell")


def test_every_piece_is_listed(bench):
    """Each configuration, traffic mix, kind of work and per-layer reader
    in the benchmark's folders serves a cell of BENCHMARK.json: a cell not
    built yet keeps no files here."""
    spec = harness.Spec()
    mixes = {w["traffic"] for w in bench["workloads"]}
    kinds = {spec.traffic(t)["kind"] for t in mixes}
    files = {c["file"] for c in bench["configs"]}
    readers = {m["name"] for m in bench["per_layer"]}

    def stems(folder, ext):
        return {f[:-len(ext)] for f in os.listdir(os.path.join(BENCH, folder))
                if f.endswith(ext)}

    assert stems("traffic", ".json") == mixes
    assert stems("kinds", ".py") == kinds
    assert stems("metrics", ".py") == readers
    assert {"benchmark/configs/" + f + ".json"
            for f in stems("configs", ".json")} == files


def test_every_file_is_named_from_name_characters():
    for dirpath, _dirs, files in os.walk(BENCH):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
