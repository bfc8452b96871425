"""The WEBSOM configuration and its cell ``websom-fit``, and the four-card
cell ``seismic-fit-dp4``, loaded through ``manifest.run_spec``; a sound
run of ``websom-fit`` at a small map of the configuration's width on the
CPU, and its control and two planted faults, judged by the
configuration's reference."""

import json
import os
import subprocess
import sys
import time

import pytest

import calibrate
from harness import check, launch, manifest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PORTBENCH)
SEED = 2**31 + 1919


def test_the_websom_configuration_as_published():
    spec = manifest.run_spec(CHECKOUT, "websom-fit", SEED, 50, False)
    config, som = spec["config"], spec["config"]["som"]
    assert (som["x"], som["y"], som["input_len"]) == (1044, 960, 500)
    assert som["x"] * som["y"] == 1_002_240 and som["sigma"] == min(som["x"], som["y"]) / 2
    assert config["n_features"] == som["input_len"] and config["source_n_samples"] == 6_840_568
    assert config["reduced"] == ["n_samples"] and config["n_samples"] == 2**18
    assert config["reference"] == "reference/som_separable.py" and config["control"]["som"] == {
        "bmu_precision": "bf16"}
    assert config["checked_epochs"] and set(config["checked_epochs"]) <= set(check.EPOCHS)
    assert config["deployment"] and len(config["assumed"]) >= 6
    assert spec["mix"]["epochs"] == 5 and spec["mix"]["mesh"] is None and spec["world"] == 1
    # the largest unit gap is one near-tie row's move at this size, and TE
    # reads one row for the sound runs and the control alike: neither is
    # compared (PERF.md)
    assert set(spec["limits"]) == {"step_gap_median", "rerun_apart", "qe_gap"}
    assert spec["limits"]["rerun_apart"] == 0
    names = {m["name"] for m in spec["metrics"]}
    assert names == {"train_samples_per_s", "score_rows_per_s", "setup_s"}
    traced = {m["name"] for m in manifest.run_spec(CHECKOUT, "websom-fit", SEED, 50, True)["metrics"]}
    assert {"codebook_io_ms.train", "codebook_io_ms.score", "kernels_roofline.train"} <= traced


def test_the_four_card_cell():
    spec = manifest.run_spec(CHECKOUT, "seismic-fit-dp4", SEED, 50, True)
    assert spec["world"] == 4 and spec["mix"]["mesh"] == "auto"
    assert spec["config"]["name"] == "dasf-seismic-128x128x64"
    assert spec["limits"]["ranks_apart"] == 0
    assert "allreduce_ms_per_epoch" in {m["name"] for m in spec["metrics"]}
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert [w["name"] for w in bench["workloads"] if w["chips"] == 4] == ["seismic-fit-dp4"]


def _small():
    """``websom-fit`` on the CPU: a 12 x 10 map of the configuration's 500
    attributes on 2048 rows, the cell's own limits and traffic."""
    spec = manifest.run_spec(CHECKOUT, "websom-fit", SEED, 0.05, False)
    spec.update(device="cpu", started=time.time())
    spec["config"]["n_samples"] = 2048
    spec["config"]["som"].update(x=12, y=10, sigma=5)
    return spec


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def test_a_sound_small_run_is_correct():
    code, result, found = launch.run(_small())
    assert code == 0 and found == [] and result["correct"], result["checks"]


def test_the_control_is_not_correct():
    spec = _small()
    code, numbers = calibrate.reading(dict(spec, seconds=0), "control")
    assert code == 0
    correct, compared = check.verdict(numbers, spec["limits"])
    assert not correct, compared


@pytest.mark.parametrize("plant", ["altered_answer.py", "unchanged.py"])
def test_a_fault_is_not_correct(plant, tmp_path):
    """The fault planted in a process of its own (a rank's), so that it
    breaks nothing else."""
    spec = dict(_small(), plant=os.path.join(PORTBENCH, "tests", "faults", plant), tmpdir=str(tmp_path))
    path = os.path.join(tmp_path, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    out = subprocess.run([sys.executable, os.path.join(PORTBENCH, "harness", "rank.py"), path, "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith(launch.RESULT_MARK)][-1]
    result = json.loads(line[len(launch.RESULT_MARK):])["result"]
    assert not result["correct"], result["checks"]
