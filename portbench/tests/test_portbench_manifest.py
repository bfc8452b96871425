"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names. CPU only; run with ``python -m pytest portbench/tests -q``."""

import json
import os
import re

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PORTBENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(_line(w) for w in bench["command"]) and len(bench["command"]) <= 32
    assert os.path.getsize(os.path.join(CHECKOUT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_just_their_keys(bench, group, keys):
    optional = {"workloads"} if group in ("end_to_end", "per_layer") else set()
    for entry in bench[group]:
        assert set(entry) - optional == keys


def test_names_and_units_use_the_allowed_characters(bench):
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for e in bench[g]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for g in ("end_to_end", "per_layer") for m in bench[g])
    assert all(m["better"] in ("lower", "higher") for g in ("end_to_end", "per_layer") for m in bench[g])
    for g in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in bench[g]}) == len(bench[g])
    assert all(_line(t) for t in [w["why"] for w in bench["workloads"]] + [c["why"] for c in bench["configs"]]
               + [c["source"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]])


def test_metric_sources_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_per_layer_metrics_cells_report_what_it_moves(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        listed = set(m.get("workloads", e2e[m["moves"]]))
        assert listed <= cells and listed <= e2e[m["moves"]], m["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        ends = [m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layers = [m for m in bench["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in ends and len(ends) >= 2 and layers, w["name"]


def test_at_most_a_quarter_of_the_cells_ask_for_four_chips(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_configuration_and_traffic_pairs_are_unique(bench):
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_every_file_the_manifest_names_exists(bench):
    assert bench["paths"] == ["portbench"]
    assert bench["command"][1] == "portbench/run.py"
    assert os.path.isfile(os.path.join(CHECKOUT, bench["command"][1]))
    files = {c["file"] for c in bench["configs"]}
    assert len(files) == len(bench["configs"])
    for c in bench["configs"]:
        path = os.path.join(CHECKOUT, c["file"])
        assert c["file"].startswith("portbench/") and os.path.isfile(path)
        with open(path) as f:
            config = json.load(f)
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(PORTBENCH, config["reference"]))
        for name in config["work"].values():
            assert os.path.isfile(os.path.join(PORTBENCH, "work", f"{name}.py"))
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(PORTBENCH, "traffic", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(PORTBENCH, "limits", f"{w['name']}.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "setup_s":
            continue
        whole = os.path.join(PORTBENCH, "metrics", f"{m['name']}.py")
        base = os.path.join(PORTBENCH, "metrics", f"{m['name'].partition('.')[0]}.py")
        assert os.path.isfile(whole) or os.path.isfile(base), m["name"]


def test_reduced_names_no_width(bench):
    widths = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|input_len|^x$|^y$")
    for c in bench["configs"]:
        assert not [k for k in c["reduced"] if widths.search(k)]


def test_roofline_and_mfu_names(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
