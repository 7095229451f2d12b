"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery by name: every file a cell needs is found from its entries, and a
new cell needs only new files and entries."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from h100bench import harness
from h100bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
M = tiny.MANIFEST
E2E = {m["name"]: m for m in M["end_to_end"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(M) == TOP_KEYS
    assert M["command"] == ["python3", "h100bench/run.py"]
    assert M["paths"] == ["h100bench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    cells = len(M["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(M["configs"]) <= 24
    # A full check of 24 cells (2 + 14 runs a cell, 60 s and 2 x 90 s of
    # allowance, 1,200 s spare) must fit in 43,200 s.
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines_are_well_formed():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_every_cell_finds_its_files_and_reports_what_it_must(cell):
    """The benchmark's cells, and those it leaves out but rehearses."""
    M = tiny.REHEARSAL
    w = tiny.cell(cell)
    cfg = next(c for c in M["configs"] if c["name"] == w["config"])
    assert cfg["file"] == f"h100bench/configs/{w['config']}.json"
    for path in (tiny.BENCH / "configs" / f"{w['config']}.json",
                 tiny.BENCH / "limits" / f"{w['config']}.json",
                 tiny.BENCH / "traffic" / f"{w['traffic']}.json"):
        json.loads(path.read_text())
    config = json.loads((tiny.BENCH / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((tiny.BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    for kind, name in (("front_ends", config["front_end"]), ("arrivals", mix["arrivals"]),
                       ("requests", mix["request"])):
        assert (tiny.BENCH / kind / f"{name}.py").is_file()
        assert (kind != "front_ends" or
                (tiny.BENCH / "reference" / kind / f"{name}.py").is_file())
    e2e = harness.cell_metrics(M, cell, trace=False)
    per_layer = harness.cell_metrics(M, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    for m in e2e:
        assert hasattr(harness.load_reader("end_to_end", m["name"]), "read")
    for m in per_layer:
        assert m["moves"] in {x["name"] for x in e2e}, (m["name"], cell)
        assert hasattr(harness.load_reader("layer_metrics", m["name"]), "read")


def test_every_metric_names_reported_cells_and_an_end_to_end_metric():
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in M["per_layer"]:
        assert m["moves"] in E2E
        for cell in m["workloads"]:
            assert cell in E2E[m["moves"]].get("workloads", [cell])
    for c in M["configs"]:
        assert any(w["config"] == c["name"] for w in M["workloads"])


PACED = '''"""A test arrival process: a closed loop whose callers wait ``think_s``
before their next request."""
import math
import threading


def in_flight(mix):
    return int(mix["clients"])


def drive(loop, traffic, tick):
    for _ in range(in_flight(traffic.mix)):
        loop.submit_next()
    tick(math.inf)


def on_answer(loop):
    threading.Timer(loop.traffic.mix["think_s"], loop.submit_next).start()


def owns(r, t0, t1):
    return not math.isnan(r.t_done) and t0 <= r.t_done < t1
'''

NEW_CELLS = {
    # A new mix file and a cell entry.
    "es-bow-cobi.news-short": ("es-bow-cobi", "news-short"),
    # A new configuration file: the engine's own keywords as data.
    "es-bow-cobi2.news-batch": ("es-bow-cobi2", "news-batch"),
    # A new arrival process: its file and a mix that names it.
    "es-bow-cobi.news-paced": ("es-bow-cobi", "news-paced"),
}


@pytest.mark.parametrize("new", sorted(NEW_CELLS))
def test_a_new_cell_needs_only_new_files_and_entries(new, tmp_path, monkeypatch):
    """A copy of the benchmark gains a cell from files and entries alone, and
    the harness, unedited, runs it (at the tiny sizes)."""
    import time

    import torch

    config, traffic = NEW_CELLS[new]
    bench = tmp_path / "h100bench"
    shutil.copytree(tiny.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = tiny.mix("news-batch")
    if traffic == "news-short":
        mix.update(sentences=[8, 12], m=4)
    if traffic == "news-paced":
        mix.update(arrivals="paced", think_s=0.01)
        (bench / "arrivals" / "paced.py").write_text(PACED)
    (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    cfg = tiny.config("es-bow-cobi")
    if config == "es-bow-cobi2":
        cfg["engine"].update(n_chips=2, pool_workers=0)
        shutil.copy(bench / "limits" / "es-bow-cobi.json", bench / "limits" / f"{config}.json")
    (bench / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    manifest = json.loads(json.dumps(M))
    manifest["workloads"].append({"name": new, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "a test cell"})
    next(m for m in manifest["end_to_end"] if m["name"] == "summaries_per_s")[
        "workloads"].append(new)
    monkeypatch.setattr(harness, "BENCH", bench)
    out = harness.run_cell(manifest, new, seed=tiny.SEED, seconds=1.0, trace=False,
                           device=torch.device("cpu"), t_process=time.perf_counter(),
                           log=lambda s: None)
    assert out["correct"] and set(out["metrics"]) == {"summaries_per_s", "setup_s"}


def test_an_engine_keyword_the_engine_does_not_take_is_refused():
    from h100bench import system

    cfg = tiny.config("es-bow-cobi")
    cfg["engine"]["routeing"] = True
    with pytest.raises(ValueError, match="routeing"):
        system.engine_kwargs(cfg)
    cfg["engine"] = {"device": "cpu"}  # the harness's to set
    with pytest.raises(ValueError, match="device"):
        system.engine_kwargs(cfg)
