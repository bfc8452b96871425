"""On the card: one cell runs from the checkout, and the same command in
a directory that holds only ``BENCHMARK.json`` and ``portbench/`` fails
with no result. Marked ``cuda``; each test skips without a card.

    python -m pytest -m cuda portbench/tests/test_portbench_card.py -q
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PORTBENCH)
COMMAND = [sys.executable, "portbench/run.py", "--workload", "seismic-predict-online",
           "--seed", "2147483701", "--seconds", "3", "--trace", "0"]

pytestmark = pytest.mark.cuda


def _need_a_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_a_cell_runs_and_is_correct():
    _need_a_card()
    out = subprocess.run(COMMAND, cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert "predict_p95_ms" in result["metrics"] and "setup_s" in result["metrics"]


def test_the_benchmark_alone_gives_no_result(tmp_path):
    _need_a_card()
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(COMMAND, cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
