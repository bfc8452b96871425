"""``run.py`` as a benchmark run calls it, on a machine without a card."""

import os
import subprocess
import sys

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PORTBENCH)


def _run(*args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=CHECKOUT,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("workload", ["seismic-fit", "seismic-predict-online"])
def test_without_a_card_it_exits_with_no_result(workload):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run("--workload", workload, "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0")
    assert out.returncode == 3 and out.stdout == ""
    assert "is_available() is false" in out.stderr


def test_an_unknown_cell_is_refused():
    out = _run("--workload", "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode == 2 and out.stdout == ""


def test_four_ranks_without_cards_give_no_result():
    import time

    import torch

    from harness import launch, manifest

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    spec = manifest.run_spec(CHECKOUT, "seismic-fit", 2**31 + 6, 1.0, False)
    spec.update(world=4, mix=dict(spec["mix"], mesh="auto"), started=time.time())
    code, result, found = launch.run(spec)
    assert code == 3 and result is None
