"""The port's supervised sweep rows (``vae-sweep-torch --isolate``) on the CPU.

  - ``_scripts/_supervise.py`` ``run_supervised`` against the JAX package's
    on the same fake children (``python -c``), each printing its own
    package's init marker: a healthy child, a silent one (init hang), one
    that prints the marker and sleeps past the deadline, a crashing one and
    one deaf to SIGTERM (killed); the ``Outcome`` fields must be equal. The
    30 s between SIGTERM and SIGKILL is cut to 1 s for both packages here,
    through ``Popen.wait``. A child outlives no parent: killed with SIGKILL,
    the supervising process takes its child with it;
  - ``sweep.run_isolated``: a tiny ``--device cpu`` row in a child equals
    the same row in process bitwise; a crashing row fails after its retries
    without raising; a retry's argv resumes (``--resume <run_dir>``, no
    ``-ow``) when the current checkpoint, only the ``.prev`` trio or only a
    DCP directory exists, and starts over otherwise; the init deadline ends
    a silent child, and the ``device:`` line lifts it;
  - the supervisor imports nothing beyond the standard library.
"""

import ast
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu._scripts import _supervise as jax_supervise  # noqa: E402
from vae_training_tpu_torch._scripts import _supervise, sweep  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRACE = 1.0  # seconds between SIGTERM and SIGKILL in these tests (30 in both modules)


class _QuickGracePopen(subprocess.Popen):
    """Popen whose timed waits last at most GRACE: both supervisors' 30 s
    SIGTERM grace, at a test's scale."""

    def wait(self, timeout=None):
        return super().wait(timeout if timeout is None else min(timeout, GRACE))


# (child body with {marker} for the package's init marker, timeouts, mode)
CHILDREN = {
    "healthy": ("import sys; print('{marker} x', file=sys.stderr, flush=True); "
                "print('banner', flush=True); sys.exit(0)", 5, 10, "capture"),
    "silent": ("import time; time.sleep(60)", 2, 30, "forward"),
    "marker_then_sleep": ("import sys, time; print('{marker} x', file=sys.stderr, "
                          "flush=True); time.sleep(60)", 2, 4, "forward"),
    "crashing": ("import sys; print('{marker} x', file=sys.stderr, flush=True); "
                 "print('partial', flush=True); sys.exit(3)", 5, 10, "capture"),
    "sigterm_deaf": ("import signal, sys, time; signal.signal(signal.SIGTERM, "
                     "signal.SIG_IGN); print('{marker} x', file=sys.stderr, flush=True); "
                     "time.sleep(60)", 5, 2, "forward"),
}
EXPECTED = {  # (returncode, hung, init_hang, stdout)
    "healthy": (0, False, False, "banner\n"),
    "silent": (None, True, True, ""),
    "marker_then_sleep": (None, True, False, ""),
    "crashing": (3, False, False, "partial\n"),
    "sigterm_deaf": (None, True, False, ""),
}


@pytest.mark.parametrize("kind", list(CHILDREN))
def test_run_supervised_matches_the_jax_supervisor(kind, monkeypatch, capsys):
    body, init_timeout, total_timeout, mode = CHILDREN[kind]
    monkeypatch.setattr(subprocess, "Popen", _QuickGracePopen)
    outcomes, waits = [], []
    for run, marker, extra in ((jax_supervise.run_supervised, "devices:",
                                {"cooldown_after_kill": False}),
                               (_supervise.run_supervised, "device:", {})):
        t = time.monotonic()
        out = run([sys.executable, "-c", body.format(marker=marker)],
                  init_timeout=init_timeout, total_timeout=total_timeout,
                  stdout_mode=mode, label="t", **extra)
        waits.append(time.monotonic() - t)
        outcomes.append((out.returncode, out.hung, out.init_hang, out.stdout))
    assert outcomes[0] == outcomes[1] == EXPECTED[kind]
    err = capsys.readouterr().err
    if kind == "silent":
        assert err.count("(init hang); terminating") == 2
    if kind in ("marker_then_sleep", "sigterm_deaf"):
        assert err.count(f"run exceeded {total_timeout}s; terminating") == 2
        assert "init hang" not in err
    # the deaf child costs the grace and the SIGKILL, no cooldown
    assert max(waits) < total_timeout + GRACE + 10


def test_a_killed_supervisor_takes_its_child_along(tmp_path):
    """SIGKILL the supervising process (no finally runs): the child, which
    would sleep for a minute, ends with it."""
    pid_file = tmp_path / "child.pid"
    child = f"import os, time; open({str(pid_file)!r}, 'w').write(str(os.getpid())); time.sleep(60)"
    parent = ("import sys; sys.path.insert(0, %r); "
              "from vae_training_tpu_torch._scripts._supervise import run_supervised; "
              "run_supervised([sys.executable, '-c', %r], init_timeout=60, total_timeout=60)"
              % (REPO, child))
    proc = subprocess.Popen([sys.executable, "-c", parent])
    try:
        deadline = time.monotonic() + 30
        while not (pid_file.exists() and pid_file.read_text()):
            assert time.monotonic() < deadline, "the child never started"
            time.sleep(0.1)
        pid = int(pid_file.read_text())
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        deadline = time.monotonic() + 10
        while _alive(pid):
            assert time.monotonic() < deadline, "the child outlived its supervisor"
            time.sleep(0.1)
    finally:
        if proc.poll() is None:
            proc.kill()


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ")[-1][0] != "Z"  # a zombie has ended
    except OSError:
        return False


def test_the_supervisor_imports_only_the_standard_library():
    path = os.path.join(REPO, "vae_training_tpu_torch", "_scripts", "_supervise.py")
    tree = ast.parse(open(path).read())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert mods <= set(sys.stdlib_module_names), mods
    code = ("import sys; import vae_training_tpu_torch._scripts._supervise; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True).stdout
    assert out.strip() == "False"


def _row(tmp_path, num_batches=20):
    """The linear sweep's last run, shrunk to a few CPU steps."""
    cfg = list(sweep.sweep_configs("linear", str(tmp_path), num_batches, "auto",
                                   device="cpu"))[-1]
    return cfg


def _same_run(a, b):
    za, zb = np.load(os.path.join(a, "losses.npz")), np.load(os.path.join(b, "losses.npz"))
    assert za.files == zb.files
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with open(os.path.join(a, "model.pkl"), "rb") as f:
        pa = pickle.load(f)
    with open(os.path.join(b, "model.pkl"), "rb") as f:
        pb = pickle.load(f)
    assert pickle.dumps(pa) == pickle.dumps(pb)
    from vae_training_tpu_torch.runio.checkpoint import restore_checkpoint

    sa, sb = restore_checkpoint(a), restore_checkpoint(b)
    assert (sa.step, sa.count, sa.data_seed, sa.model_seed) == \
        (sb.step, sb.count, sb.data_seed, sb.model_seed)
    for tree in ("params", "m", "v"):
        for k, t in getattr(sa, tree).items():
            assert torch.equal(t, getattr(sb, tree)[k]), (tree, k)


def test_an_isolated_row_equals_the_in_process_row(tmp_path, capsys):
    argv = ["linear", "--num_batches", "20", "--device", "cpu", "--shard", "20/21"]
    assert sweep.main([*argv, "--data_dir", str(tmp_path / "inproc")]) == 0
    assert sweep.main([*argv, "--isolate", "--data_dir", str(tmp_path / "iso")]) == 0
    out = capsys.readouterr().out
    name = "vae12linear_gaussian_20dim4"
    assert out.count(f"[sweep] {name} done in") == 2
    assert "[kernels] torch: plain PyTorch path" in out  # the child's, forwarded
    _same_run(tmp_path / "inproc" / name, tmp_path / "iso" / name)


def test_a_crashing_row_fails_after_its_retries(tmp_path, capsys):
    cfg = _row(tmp_path)
    cfg.dataset = "4gaussian"  # the child's parser refuses it: exit code 2
    assert sweep.run_isolated(cfg, timeout=120, retries=1) is False
    out = capsys.readouterr().out
    assert f"[sweep] {cfg.name} attempt 1 exited 2" in out
    assert f"[sweep] {cfg.name} attempt 2 exited 2" in out


def _record_argvs(monkeypatch, code="import sys; sys.exit(1)"):
    """run_isolated's children become ``python -c code``; their argv is kept."""
    seen = []
    real = subprocess.Popen

    def fake_popen(argv, **kwargs):
        seen.append(list(argv))
        return real([sys.executable, "-c", code], **kwargs)

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    return seen


def _ckpt_only_current(run_dir, state):
    from vae_training_tpu_torch.runio.checkpoint import save_checkpoint

    save_checkpoint(run_dir, state)


def _ckpt_only_prev(run_dir, state):
    """A kill between the retention set-aside and the install: the .prev trio."""
    from vae_training_tpu_torch.runio.checkpoint import save_checkpoint

    save_checkpoint(run_dir, state)
    for name in ("ckpt.pt", "ckpt_aux.pkl", "ckpt_meta.json"):
        if os.path.exists(os.path.join(run_dir, name)):
            os.replace(os.path.join(run_dir, name), os.path.join(run_dir, name + ".prev"))


def _ckpt_only_dcp(run_dir, state):
    from vae_training_tpu_torch.runio.checkpoint import save_checkpoint_dcp

    save_checkpoint_dcp(run_dir, state)


@pytest.mark.parametrize("make", [None, _ckpt_only_current, _ckpt_only_prev, _ckpt_only_dcp],
                         ids=["none", "current", "prev_trio", "dcp"])
def test_a_retry_resumes_from_the_rows_checkpoint(tmp_path, monkeypatch, make):
    from vae_training_tpu_torch.train.state import TrainState

    cfg = _row(tmp_path)
    run_dir = os.path.join(cfg.data_dir, cfg.name)
    os.makedirs(run_dir)
    if make is not None:
        params = {"w": torch.ones(2, 3)}
        make(run_dir, TrainState.create(params, 1, 2))
    seen = _record_argvs(monkeypatch)
    assert sweep.run_isolated(cfg, timeout=60, retries=1) is False
    assert len(seen) == 2
    first, retry = seen
    assert first[1:3] == ["-m", "vae_training_tpu_torch._scripts.run"]
    assert first[3:] == sweep.cfg_to_argv(cfg) and "-ow" in first and "--resume" not in first
    if make is None:
        assert retry == first  # nothing to resume from: start over
    else:
        assert "-ow" not in retry and retry[-2:] == ["--resume", run_dir]
        assert [a for a in first if a != "-ow"] == retry[:-2]


def test_a_silent_child_meets_the_init_deadline(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("VAE_SWEEP_INIT_TIMEOUT", "2")
    _record_argvs(monkeypatch, "import time; time.sleep(60)")
    t = time.monotonic()
    assert sweep.run_isolated(_row(tmp_path), timeout=600, retries=0) is False
    assert time.monotonic() - t < 30  # nowhere near the row timeout
    assert "(init hang)" in capsys.readouterr().err


def test_the_device_line_lifts_the_init_deadline(tmp_path, monkeypatch, capsys):
    """The CLI's stderr line ``device: ...`` (printed before the kernels'
    first-use build) is a sign of life: such a child meets only the row
    timeout, though its stdout stays silent past the init deadline."""
    monkeypatch.setenv("VAE_SWEEP_INIT_TIMEOUT", "2")
    _record_argvs(monkeypatch, "import sys, time; print('device: cuda (NVIDIA H100)', "
                               "file=sys.stderr, flush=True); time.sleep(60)")
    assert sweep.run_isolated(_row(tmp_path), timeout=5, retries=0) is False
    err = capsys.readouterr().err
    assert "device: cuda (NVIDIA H100)" in err  # forwarded
    assert "run exceeded 5s (attempt 1/1); terminating" in err and "init hang" not in err
