"""BENCHMARK.json against the contract's shape, and every name in it
resolved to its files: configurations, mixes, limits and metric readers."""

import json
import os
import re

import pytest

from perfbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in bench["command"])


def test_names_and_units(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits", "metrics"])
def test_every_name_has_its_file(bench, kind):
    here = os.path.join(common.ROOT, "perfbench")
    if kind == "configs":
        files = [os.path.join(common.ROOT, c["file"]) for c in bench["configs"]]
    elif kind == "traffic":
        files = [os.path.join(here, "traffic", w["traffic"] + ".json")
                 for w in bench["workloads"]]
    elif kind == "limits":
        files = [os.path.join(here, "limits", w["name"] + ".json")
                 for w in bench["workloads"]]
    else:
        files = [os.path.join(here, "metrics", m["name"] + ".py")
                 for m in bench["per_layer"]]
    assert all(os.path.exists(f) for f in files), files


def test_cells_load_and_report_one_of_each(bench):
    for w in bench["workloads"]:
        cell = common.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        assert all(m["moves"] in e2e for m in cell.per_layer)
        assert cell.model["name"] == w["config"]


def test_reduced_keys_differ_from_their_published_values(bench):
    for c in bench["configs"]:
        with open(os.path.join(common.ROOT, c["file"])) as f:
            model = json.load(f)
        for key in c["reduced"]:
            assert model[key] != model["published"][key]
