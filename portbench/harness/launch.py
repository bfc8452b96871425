"""Start a run: in this process for one card, or as one process a card
for a cell that asks for more (``rank.py``, joined over
``tcp://127.0.0.1:<free port>``; rank 0 prints the result, which is
passed on). Every process started here is waited for, and killed at the
deadline or when a rank fails."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

__all__ = ["pin_caches", "run", "RANK_DEADLINE_S", "RESULT_MARK"]

RANK_DEADLINE_S = 330.0  # a run ends within 360 s
RESULT_MARK = "portbench-result "


def pin_caches(checkout: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the kernel library itself goes to ``build/kernels``, beside the
    package)."""
    base = os.path.join(checkout, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def cards_missing(torch, world: int):
    """Why this machine cannot run the cell, or None."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < world:
        return f"{torch.cuda.device_count()} CUDA card(s), the cell asks for {world}"
    return None


def run(spec: dict):
    """``(exit code, result or None, forbidden modules found)``."""
    if int(spec["world"]) == 1:
        return _in_process(spec)
    return _ranks(spec)


def _in_process(spec):
    import torch

    from . import cell

    if spec["device"] == "cuda":
        why = cards_missing(torch, 1)
        if why:
            print(f"portbench: {why}", file=sys.stderr)
            return 3, None, []
    spec = dict(spec, tmpdir=spec.get("tmpdir") or tempfile.gettempdir())
    result, found = cell.run(spec)
    return 0, result, found


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(spec):
    world = int(spec["world"])
    tmp = tempfile.mkdtemp(prefix="portbench-", dir=spec.get("tmpdir"))
    spec = dict(spec, tmpdir=tmp, addr=f"tcp://127.0.0.1:{_free_port()}")
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rank.py")
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, script, path, str(r)], env=env, text=True,
                stdout=subprocess.PIPE if r == 0 else sys.stderr))
        try:
            out = procs[0].communicate(timeout=RANK_DEADLINE_S)[0]
            for p in procs[1:]:
                p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            print(f"portbench: a rank did not finish in {RANK_DEADLINE_S} s", file=sys.stderr)
            return 1, None, []
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"portbench: rank exit codes {codes}", file=sys.stderr)
        return max(codes), None, []
    lines = [ln for ln in out.splitlines() if ln.startswith(RESULT_MARK)]
    if not lines:
        print("portbench: rank 0 gave no result", file=sys.stderr)
        return 1, None, []
    payload = json.loads(lines[-1][len(RESULT_MARK):])
    return 0, payload["result"], payload["found"]
