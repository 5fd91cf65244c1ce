"""The port's training CLI, ``python -m repro_torch.launch.train``, on the
CPU (``--device cpu``, the kernels' plain versions): both DP tiers, the
drop schedule, the spend report, the wire tier's rounds (``--wire-rounds``;
fault-tolerant with ``--chaos-seed``, ``--round-timeout``, ``--quorum`` and
``--journal``), the flags whose paths are not ported yet, and the refusal
to fall back to the CPU without ``--device``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--steps", "2", "--batch", "8", "--seq", "8"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size work gains nothing from many intra-op threads, and the
    suite runs several test files at once: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tier", ["fused", "barrier"])
def test_cli_trains_both_tiers_on_cpu(tier, tmp_path, capsys):
    report = tmp_path / "spend.json"
    before = dispatch.launch_counts()
    res = train.main(SMALL + ["--sync-path", tier, "--silos", "4", "--lam",
                              "0.7", "--dynamic-clip", "--drop-silos", "1:2",
                              "--spend-report", str(report)])
    assert dispatch.launch_counts() == before  # CPU: plain versions only
    assert res.step == 2 and np.isfinite(res.final["loss"])
    assert [m["n_contributions"] for m in res.metrics] == [4.0, 3.0]
    assert res.trainer.run_cfg.privacy.sync_path == tier
    stages = set(res.trainer.stage_log[0])
    assert ("contributions" in stages) == (tier == "barrier")
    spend = json.loads(report.read_text())
    assert [s["steps_sat_out"] for s in spend["silos"]] == [0, 0, 1, 0]
    out = capsys.readouterr().out
    assert f"({tier} tier)" in out and "| silo |" in out


def test_cli_barrier_mesh_comes_from_silos():
    res = train.main(SMALL + ["--sync-path", "barrier", "--silos", "2",
                              "--batch", "4"])
    mesh = res.trainer.run_cfg.mesh
    assert (mesh.n_silos, mesh.silo_axes) == (2, ("data",))
    assert res.trainer.n_silos == 2


def test_drop_schedule_reads_step_silo_cooldown(capsys):
    sched = train.drop_schedule("1:3:2,4:0,2:9", 4)
    assert "silo 9 ignored" in capsys.readouterr().out
    got = [sched(t).tolist() for t in range(5)]
    assert got == [[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 1, 0], [1, 1, 1, 1],
                   [0, 1, 1, 1]]


@pytest.mark.parametrize("flags,item", [
    (["--checkpoint-dir", "ckpt"], "item 10"),
    (["--elastic"], "item 10"),
    (["--silo-epsilon-budget", "1.0"], "item 10"),
    (["--mask-mode", "admin"], "item 9"),
])
def test_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, {item}"):
        train.main(SMALL + flags)


def test_cli_runs_wire_rounds_on_cpu(tmp_path, capsys):
    """``--wire-rounds``: pipelined rounds of the wire tier's protocol on
    MNIST-MLP3, the plain ``clip_mask`` on the CPU, the signed spend report
    written."""
    report = tmp_path / "spend.json"
    before = dispatch.launch_counts()
    sess, losses = train.main(["--device", "cpu", "--wire-rounds", "2",
                               "--spend-report", str(report)])
    assert dispatch.launch_counts() == before
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert sess.accountant.contributions == [4, 4]
    assert sess.handlers[0].device == torch.device("cpu")
    spend = json.loads(report.read_text())
    assert spend["steps"] == 2 and "signature" in spend
    assert "wire tier: 2 rounds closed on cpu" in capsys.readouterr().out


def test_cli_chaos_rounds_write_a_journal_that_resumes(tmp_path, capsys):
    """``--chaos-seed`` with ``--round-timeout`` and ``--journal``: the
    tolerant rounds run (seed 5's plan crashes silo 1 in round 1; no hang)
    and journal each commit; a second call with the same journal resumes
    after the committed rounds, silo 1 still down."""
    path = tmp_path / "rounds.journal"
    flags = ["--device", "cpu", "--wire-rounds", "2", "--chaos-seed", "5",
             "--round-timeout", "30", "--journal", str(path)]
    sess, losses = train.main(flags)
    out = capsys.readouterr().out
    assert "chaos plan seed=5 hang_s=60.0" in out
    assert "quorum_closures=1" in out
    assert len(losses) == 2 and np.isfinite(losses).all()
    from repro_torch.core.tee.faults import RoundJournal
    journal = RoundJournal.load(str(path))
    assert [r["active"] for r in journal.rounds] == \
        [[True] * 4, [True, False, True, True]]
    assert journal.downed == {1: 1} and sess.accountant.contributions == [4, 3]
    sess2, losses2 = train.main(flags[:3] + ["1"] + flags[4:])
    assert "resumed from" in capsys.readouterr().out
    assert sess2.accountant.steps == 3 and len(losses2) == 1
    assert sess2.accountant.contributions == [4, 3, 3]
    assert [r["round"] for r in RoundJournal.load(str(path)).rounds] == \
        [0, 1, 2]


def test_cli_quorum_sets_the_membership_floor(monkeypatch):
    """``--quorum`` takes the tolerant rounds and is the membership's drop
    floor while they run (restored after)."""
    from repro_torch.api import CollaborativeSession

    floors = []
    step = CollaborativeSession._step_tolerant

    def spy(self, *a, **k):
        floors.append(self.membership.min_active)
        return step(self, *a, **k)

    monkeypatch.setattr(CollaborativeSession, "_step_tolerant", spy)
    sess, losses = train.main(["--device", "cpu", "--wire-rounds", "1",
                               "--quorum", "3"])
    assert floors == [3] and len(losses) == 1
    assert sess.membership.min_active == 1


@pytest.mark.parametrize("flags", [["--quorum", "2"],
                                   ["--round-timeout", "1"],
                                   ["--chaos-seed", "1", "--journal", "j"]])
def test_fault_flags_without_wire_rounds_raise(flags):
    """As in JAX: the fault flags are wire-tier options."""
    with pytest.raises(SystemExit, match="add --wire-rounds N"):
        train.main(SMALL + flags)


def test_cli_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])


def test_cli_runs_as_a_module():
    """The command a user types, in a fresh interpreter."""
    # one thread (torch, MKL): the suite runs several files at once, and
    # wall-clock tests share the cores
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--device", "cpu", "--sync-path", "barrier",
                        "--silos", "4", "--steps", "2"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done at step 2 on cpu (barrier tier)" in r.stdout
