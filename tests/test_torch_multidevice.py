"""The sharded port on the CPU: gloo groups of 2 processes (mesh (2, 1))
and 4 (mesh (2, 2)), each rank one process running
``tests/_torch_mesh_worker.py``.

What they hold, sharded against one process on the same inputs (smoke
gemma3-1b in fp32, the fp32 engine):

- two sharded train steps (and, at world 2, of smoke mamba2-1.3b and
  granite-moe-3b-a800m): the loss and every gradient leaf within 1e-6
  relative L2 (the data-parallel sums add in another order), the updated
  parameters within 5e-2 of the update's bound 2 lr (1 + wd |w|) as
  ``chip_smoke.py`` phase 13 holds them (AdamW turns rounding noise in a
  near-zero gradient into a step of about lr); AdamW's m in its ZeRO-1
  layout (sharded over ``data``);
- every op of the sharded context against the unsharded call: the int8
  GEMM and conv bit for bit, the float ops within 1e-6 of the largest
  magnitude; a batch the data axis does not divide runs whole, and dense
  decode and paged prefill (never split) run on whole operands;
- ``make_global_batch`` against ``make_batch``, each rank holding its
  rows;
- the elastic restore (world 4): saved on (4, 1) and restored onto
  (1, 4), saved on (2, 2) and restored onto (2, 2) in another layout, and
  both onto whole tensors, bit for bit.

Hangs: the rendezvous is a ``FileStore`` under ``tmp_path``, collectives
time out after 60 s, and every child is joined with a deadline after
which the test kills the group and fails.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_worker.py")
JOIN_S = 300
_RUNS = {}


def _run_group(world: int, tmp_path_factory):
    """Run (once per world size) a gloo group of ``world`` workers; the
    ranks' readings."""
    if world in _RUNS:
        return _RUNS[world]
    out = tmp_path_factory.mktemp(f"mesh{world}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    store = str(out / "store")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), store, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
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
    _RUNS[world] = (ranks, out)
    return _RUNS[world]


def _hold_train(tr):
    s, r = tr["loss0"]
    assert abs(s - r) <= 1e-6 * abs(r)
    worst = max(tr["grad_rel"], key=tr["grad_rel"].get)
    assert tr["grad_rel"][worst] <= 1e-6, (worst, tr["grad_rel"][worst])
    for sl, rl, sg, rg in tr["steps"]:
        assert abs(sl - rl) <= 1e-6 * abs(rl)
        assert abs(sg - rg) <= 1e-6 * abs(rg)
    gap = max(tr["param_gap"], key=tr["param_gap"].get)
    assert tr["param_gap"][gap] <= 5e-2, (gap, tr["param_gap"][gap])
    # ZeRO-1: every m leaf is sharded over the data axis somewhere
    # (smoke widths all divide)
    assert all(pl[0].startswith("S(")
               for pl in tr["m_layouts"].values()), tr["m_layouts"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_train_step_matches_one_process(world, tmp_path_factory):
    ranks, _ = _run_group(world, tmp_path_factory)
    for res in ranks:
        _hold_train(res["train"])
    assert len({json.dumps(r["train"]["steps"]) for r in ranks}) == 1


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "granite-moe-3b-a800m"])
def test_sharded_train_step_recurrent_and_moe(arch, tmp_path_factory):
    """The same holds for the Mamba-2 and MoE blocks (world 2)."""
    ranks, _ = _run_group(2, tmp_path_factory)
    for res in ranks:
        _hold_train(res["train_families"][arch])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ctx_ops_match_unsharded_call(world, tmp_path_factory):
    ranks, _ = _run_group(world, tmp_path_factory)
    for res in ranks:
        ops = res["ops"]
        assert len(ops) == 10, sorted(ops)
        for name, err in ops.items():
            limit = 0.0 if "int8" in name else 1e-6
            assert err <= limit, (name, err)


@pytest.mark.parametrize("world", [2, 4])
def test_global_batch_matches_make_batch(world, tmp_path_factory):
    ranks, _ = _run_group(world, tmp_path_factory)
    for res in ranks:
        b = res["batch"]
        assert b["tokens"] and b["labels"] and b["extra_embeds"], b
        assert b["tokens_local_rows"] == 8 // 2


@pytest.mark.parametrize("case", ["4x1_to_1x4", "2x2_to_2x2"])
def test_elastic_restore_onto_another_mesh(case, tmp_path_factory):
    ranks, _ = _run_group(4, tmp_path_factory)
    for res in ranks:
        el = res["elastic"][case]
        assert el["equal"] and el["layout_kept"] and el["plain_equal"], el
        assert el["files"] == ["_COMMITTED", "host_00000.npz",
                               "host_00001.npz", "host_00002.npz",
                               "host_00003.npz", "manifest.json"]
