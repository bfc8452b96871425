"""The harness drives a whole run on the CPU at a small size (its look
for a card skipped), with the timed path sound, with each fault a cell
can have planted underneath, and with the configuration's control in
the program's place: only the sound run may come out correct."""

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
FAULTS = os.path.join(PORTBENCH, "tests", "faults")
SEED = 2**31 + 12345


def _small(workload, trace=False):
    """The cell's spec on the CPU: the cell's own limits and traffic, a
    16 x 16 map of 16 features on 8192 rows."""
    spec = manifest.run_spec(CHECKOUT, workload, SEED, 0.05, trace)
    spec.update(device="cpu", started=time.time())
    spec["config"]["n_samples"] = 8192
    spec["config"]["som"].update(x=16, y=16, input_len=16, sigma=8)
    if spec["mix"]["kind"] == "predict":
        spec["mix"].update(pool_rows=8192, min_rows=4, max_rows=512, sizes=16, trace_calls=8)
    return spec


def _run(spec, plant=None, tmp=None):
    """A whole run; a planted fault runs in a process of its own (a
    rank's), so that it breaks nothing else."""
    if plant is None:
        code, result, found = launch.run(spec)
        assert code == 0 and found == []
        return result
    spec = dict(spec, plant=os.path.join(FAULTS, plant), tmpdir=str(tmp))
    if spec["world"] > 1:
        code, result, found = launch.run(spec)
        assert code == 0 and found == []
        return result
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    out = subprocess.run([sys.executable, os.path.join(PORTBENCH, "harness", "rank.py"), path, "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith(launch.RESULT_MARK)][-1]
    payload = json.loads(line[len(launch.RESULT_MARK):])
    assert payload["found"] == []
    return payload["result"]


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # four ranks share the CPU


FIT = ["seismic-fit", "seismic-manhattan-fit"]


@pytest.mark.parametrize("workload", FIT + ["seismic-predict-online"])
def test_a_sound_run_is_correct(workload):
    result = _run(_small(workload))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("workload,plant", [
    (w, p) for w in FIT for p in ("unchanged.py", "half_batch.py", "altered_answer.py")
] + [("seismic-predict-online", p) for p in ("half_batch.py", "altered_answer.py")])
def test_a_fault_is_not_correct(workload, plant, tmp_path):
    result = _run(_small(workload), plant, tmp_path)
    assert not result["correct"], result["checks"]


def _four_ranks():
    """``seismic-fit``'s job over ``mesh='auto'``, one process a rank."""
    spec = _small("seismic-fit")
    spec.update(world=4, mix=dict(spec["mix"], mesh="auto"),
                limits=dict(spec["limits"], ranks_apart=0))
    return spec


def test_four_ranks_sound_and_without_their_exchange(tmp_path):
    assert _run(_four_ranks())["correct"]
    result = _run(_four_ranks(), "no_exchange.py", tmp_path)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", FIT + ["seismic-predict-online"])
def test_the_control_is_not_correct(workload):
    spec = _small(workload)
    code, numbers = calibrate.reading(dict(spec, seconds=0.2), "control")
    assert code == 0
    correct, compared = check.verdict(numbers, spec["limits"])
    assert not correct, compared


def test_a_traced_run_reports_the_cells_per_layer_metrics():
    result = _run(_small("seismic-fit", trace=True))
    assert result["correct"] and "breakdown" in result
    assert {"busy_s", "window_s"} <= set(result["device"])
