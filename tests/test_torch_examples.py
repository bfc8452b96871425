"""The port's example catalog (``examples_torch/``) on the CPU: the same 17
scripts as ``examples/``, each run headless with ``--device cpu`` in a
subprocess of its own that must never import JAX, and the device rule
(no ``--device`` and no card: the port's RuntimeError)."""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLES = os.path.join(_REPO, "examples_torch")


def _catalog(folder):
    return sorted(f[:-3] for f in os.listdir(folder) if f.endswith(".py"))


_ALL = _catalog(_EXAMPLES)


def _run(name, args, prelude=""):
    """Run one example through ``runpy`` in a fresh interpreter, from the
    repository root; the interpreter fails if JAX was imported."""
    path = os.path.join(_EXAMPLES, f"{name}.py")
    code = (
        f"import runpy, sys; {prelude}"
        f"sys.argv = [{path!r}] + {list(args)!r}; "
        f"runpy.run_path({path!r}, run_name='__main__'); "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)"
    )
    # one intra-op thread: the scripts are small, and a process per script
    # beside the suite's other workers would oversubscribe the cores
    env = dict(os.environ, MPLBACKEND="Agg", OMP_NUM_THREADS="1")
    env.pop("XPYSOM_BMU_PRECISION", None)
    env.pop("XPYSOM_TPU_NO_PALLAS", None)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                          capture_output=True, text=True, timeout=300)


def test_catalog_is_the_jax_catalog():
    assert len(_ALL) == 17
    assert _ALL == _catalog(os.path.join(_REPO, "examples"))


@pytest.mark.parametrize("name", _ALL)
def test_example_runs_on_the_cpu_without_jax(name, tmp_path):
    # the streaming demo at smoke size, its dataset and checkpoint under
    # tmp_path (never the defaults another run may be writing)
    extra = {"large_scale_streaming": ["-n", "100000", "--epochs", "2",
                                       "--file", str(tmp_path / "demo.f32")]}
    proc = _run(name, ["--device", "cpu", *extra.get(name, [])])
    assert proc.returncode == 0, f"{name}.py failed:\n{proc.stderr[-1500:]}"
    assert proc.stdout.splitlines()[0] == "device=cpu"
    if name == "large_scale_streaming":
        assert (tmp_path / "demo_ckpt.npz").exists()


def test_example_without_a_device_needs_the_card():
    """No ``--device`` and no card: the port's RuntimeError, nothing run
    on the CPU."""
    proc = _run("clustering", [], prelude="import torch; torch.cuda.is_available = lambda: False; ")
    assert proc.returncode != 0
    assert "RuntimeError: no CUDA card is available" in proc.stderr
    assert "device=" not in proc.stdout
