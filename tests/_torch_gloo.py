"""Runs gloo groups of ``tests/_torch_mesh_worker.py`` processes for the
port's multi-device tests (``tests/test_torch_multidevice.py``,
``tests/test_torch_pipeline.py``).

Hangs: the rendezvous is a ``FileStore`` under the test's tmp directory,
collectives time out after 60 s, and every child is joined with a
deadline after which the group is killed and the test fails.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_worker.py")
JOIN_S = 300
_STARTED = {}
_RUNS = {}


def start_groups(keys, tmp_path_factory):
    """Start (once each) the groups ``keys`` names, (world, mode) pairs,
    side by side; :func:`run_group` waits for one."""
    for world, mode in keys:
        if (world, mode) in _STARTED:
            continue
        out = tmp_path_factory.mktemp(f"{mode}{world}")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
            env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        store = str(out / "store")
        _STARTED[world, mode] = (out, [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), store, str(out),
             mode], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)])


def run_group(world: int, tmp_path_factory, mode: str = "mesh"):
    """The readings of (once per world size and mode) a gloo group of
    ``world`` workers: (the ranks' results, the group's output
    directory)."""
    key = (world, mode)
    if key in _RUNS:
        return _RUNS[key]
    start_groups([key], tmp_path_factory)
    out, procs = _STARTED[key]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"gloo group of {world} did not finish in {JOIN_S} s")
    ranks = []
    for r in range(world):
        path = out / f"rank{r}.json"
        assert path.exists(), f"rank {r} wrote nothing:\n{logs[r][-4000:]}"
        res = json.loads(path.read_text())
        assert "error" not in res, f"rank {r}:\n{res['error']}"
        ranks.append(res)
    assert all(p.returncode == 0 for p in procs), logs
    _RUNS[key] = (ranks, out)
    return _RUNS[key]
