"""The port's training loop, launcher and example drivers on the CPU:
restart from the latest checkpoint, deterministic resume, and the entry
points run end to end with ``--device cpu``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train.loop import FailurePlan, train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("qwen2_0_5b").smoke()


def test_failure_restarts_from_latest_checkpoint(tmp_path):
    """tests/test_substrate.py::test_train_loop_failure_restart, in the port."""
    rep = train(CFG, seq_len=8, global_batch=2, steps=10, ckpt_dir=str(tmp_path),
                ckpt_every=3, failure_plan=FailurePlan(fail_at_steps=(5,)), device="cpu")
    assert rep.restarts == 1
    assert rep.steps_run == 12        # steps 3 and 4 run again after restoring step 3
    assert len(rep.losses) == rep.steps_run
    assert rep.losses[3:5] == rep.losses[5:7]


def test_restart_ends_on_the_uninterrupted_loss(tmp_path):
    """tests/test_substrate.py::test_train_loop_deterministic_restart_equivalence."""
    r1 = train(CFG, seq_len=8, global_batch=2, steps=8, ckpt_dir=str(tmp_path / "a"),
               ckpt_every=2, device="cpu")
    r2 = train(CFG, seq_len=8, global_batch=2, steps=8, ckpt_dir=str(tmp_path / "b"),
               ckpt_every=2, async_ckpt=True, failure_plan=FailurePlan(fail_at_steps=(5,)),
               device="cpu")
    assert r2.restarts == 1
    assert abs(r1.losses[-1] - r2.losses[-1]) < 1e-4


def test_a_second_run_resumes_from_the_store(tmp_path):
    r1 = train(CFG, seq_len=8, global_batch=2, steps=4, ckpt_dir=str(tmp_path),
               ckpt_every=2, device="cpu")
    r2 = train(CFG, seq_len=8, global_batch=2, steps=6, ckpt_dir=str(tmp_path),
               ckpt_every=2, device="cpu")
    assert r1.steps_run == 4 and r2.steps_run == 2


def test_launcher_trains_the_smoke_config_on_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "qwen2_0_5b", "--steps", "3", "--seq-len", "16",
                       "--batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                       "--fail-at", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "restarts=1" in out


def test_launcher_reports_a_run_with_nothing_left_to_do(tmp_path, capsys):
    """A second launch into a store that already holds the last step runs
    no step and says so, instead of failing on an empty loss list."""
    argv = ["--arch", "qwen2_0_5b", "--steps", "2", "--seq-len", "16", "--batch", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device", "cpu"]
    assert launch_train.main(argv).steps_run == 2
    capsys.readouterr()
    rep = launch_train.main(argv)
    assert rep.steps_run == 0 and rep.losses == []
    assert "no steps run" in capsys.readouterr().out


def _run_example(name, *args):
    return subprocess.run([sys.executable, str(ROOT / "examples" / name), *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_train_example_runs_on_cpu(tmp_path):
    r = _run_example("train_lm_torch.py", "--arch", "qwen2_0_5b", "--smoke", "--device",
                     "cpu", "--steps", "40", "--seq-len", "32", "--batch", "4",
                     "--ckpt-dir", str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "done: first loss" in r.stdout


def test_train_example_runs_on_the_procs_backend_on_cpu():
    r = _run_example("train_lm_torch.py", "--backend", "procs", "--shards", "2",
                     "--arch", "qwen2_0_5b", "--smoke", "--device", "cpu", "--steps", "20",
                     "--seq-len", "32", "--batch", "4")
    assert r.returncode == 0, r.stderr
    assert "done (procs backend, 2 shards, 61 tasks" in r.stdout


def test_train_example_runs_on_the_threads_backend_on_cpu():
    r = _run_example("train_lm_torch.py", "--backend", "threads", "--shards", "2",
                     "--arch", "qwen2_0_5b", "--smoke", "--device", "cpu", "--steps", "20",
                     "--seq-len", "32", "--batch", "4")
    assert r.returncode == 0, r.stderr
    assert "done (threads backend, 2 shards, 61 tasks" in r.stdout


@pytest.mark.parametrize("backend", ["sim", "procs"])
def test_quickstart_twin_prints_what_the_original_prints(backend):
    got = _run_example("quickstart_torch.py", "--backend", backend)
    want = _run_example("quickstart.py", "--backend", backend)
    assert got.returncode == 0 == want.returncode, got.stderr + want.stderr
    if backend == "sim":
        assert got.stdout == want.stdout
    else:       # wall seconds differ
        assert got.stdout.splitlines()[-1] == want.stdout.splitlines()[-1] \
            == "parallel == serial: 1240"


def test_scheduling_at_scale_twin_prints_what_the_original_prints():
    """Virtual time: the port's runtime and ``locality_sweep`` print the
    JAX example's numbers exactly."""
    got = _run_example("scheduling_at_scale_torch.py")
    want = _run_example("scheduling_at_scale.py")
    assert got.returncode == 0 == want.returncode, got.stderr + want.stderr
    assert got.stdout == want.stdout and "despite the failure" in got.stdout


def test_serve_example_runs_on_cpu():
    r = _run_example("serve_lm_torch.py", "--device", "cpu", "--requests", "3",
                     "--max-new-tokens", "2")
    assert r.returncode == 0, r.stderr
    assert "'completed': 3" in r.stdout
