"""The port's background artifact writer (``runio/background.py``): the cases
of ``tests/test_background_writer.py`` on the port's writer, ``Trainer``
and ``GridTrainer``, plus the port's own hazard: the kernels and the torch
path update the state in place, so a save must copy it to the host when
it is submitted, not when it is written."""

import os
import pickle
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch.config import parse_arguments  # noqa: E402
from vae_training_tpu_torch.data import get_dataset  # noqa: E402
from vae_training_tpu_torch.runio.background import (  # noqa: E402
    ArtifactWriter,
    get_artifact_writer,
)
from vae_training_tpu_torch.runio.checkpoint import restore_checkpoint  # noqa: E402
from vae_training_tpu_torch.runio.export import load_model_pkl  # noqa: E402
from vae_training_tpu_torch.runio.outdir import make_output_dir  # noqa: E402
from vae_training_tpu_torch.train.grid import GridTrainer  # noqa: E402
from vae_training_tpu_torch.train.loop import Trainer  # noqa: E402

ROW = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
       "-ow", "--latent_dim", "6", "--padding_dim", "3", "-dd", "3", "--epsilon", "-1",
       "-tdv", "-ds", "2", "-lr", "1e-3", "--batch_size", "20", "--device", "cpu"]


def make_cfg(data_dir, num_batches=120, *extra):
    cfg = parse_arguments(["bg", *ROW, "--num_batches", str(num_batches),
                           "--data_dir", str(data_dir), *extra])
    cfg.tqdm = False
    return cfg.validate()


def build_trainer(data_dir, num_batches=120):
    cfg = make_cfg(data_dir, num_batches)
    out = make_output_dir(cfg.name, True, cfg, data_dir=cfg.data_dir)
    ds = get_dataset(cfg.dataset, cfg.dataset_seed, cfg, device=torch.device("cpu"))
    return Trainer(cfg, ds, out), out


def test_writer_runs_jobs_in_fifo_order():
    w = ArtifactWriter()
    seen = []
    for i in range(20):
        w.submit(lambda i=i: seen.append(i))
    w.drain()
    assert seen == list(range(20))


def test_writer_drain_waits_for_slow_job():
    w = ArtifactWriter()
    done = []

    def slow():
        time.sleep(0.2)
        done.append(1)

    w.submit(slow)
    w.drain()
    assert done == [1]


def test_writer_failure_surfaces_on_drain_and_next_submit():
    w = ArtifactWriter()
    w.submit(lambda: (_ for _ in ()).throw(ValueError("disk full")))
    with pytest.raises(RuntimeError, match="artifact write failed") as ei:
        w.drain()
    assert isinstance(ei.value.__cause__, ValueError)
    w.submit(lambda: None)  # the raise consumed the error; the writer goes on
    w.drain()
    w.submit(lambda: (_ for _ in ()).throw(OSError("boom")))
    w._q.join()  # the job ran and stored its error; nothing raised yet
    with pytest.raises(RuntimeError, match="artifact write failed"):
        w.submit(lambda: None)


def test_drain_quietly_logs_the_swallowed_failure(capsys):
    w = ArtifactWriter()
    w.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    w.drain_quietly()
    err = capsys.readouterr().err
    assert "background write failed" in err and "disk full" in err


def test_writer_failure_does_not_stop_later_jobs():
    w = ArtifactWriter()
    seen = []
    w.submit(lambda: (_ for _ in ()).throw(ValueError("x")))
    w.submit(lambda: seen.append("after"))
    with pytest.raises(RuntimeError):
        w.drain()
    assert seen == ["after"]


def test_writer_queue_is_bounded_backpressure():
    w = ArtifactWriter()
    gate = threading.Event()
    w.submit(gate.wait)  # occupy the worker
    assert w._q.maxsize > 0
    for _ in range(w._q.maxsize):
        w.submit(lambda: None)
    blocked = threading.Event()

    def producer():
        w.submit(lambda: None)  # blocks until the worker frees a slot
        blocked.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    assert not blocked.wait(0.3)
    gate.set()
    assert blocked.wait(5.0)
    t.join(5.0)
    assert not t.is_alive()
    w.drain()


def test_process_writer_is_a_singleton():
    assert get_artifact_writer() is get_artifact_writer()


def _held(fn):
    """Run ``fn`` while the process writer is held behind a gate; returns
    the gate's release."""
    gate = threading.Event()
    get_artifact_writer().submit(gate.wait)
    fn()
    return gate


def test_solo_save_snapshots_at_submit_time(tmp_path):
    """losses.npz, model.pkl and the checkpoint hold the state and history
    of the moment ``save`` was called, though the next chunk updates the
    parameters in place and the recorder grows before the write runs."""
    trainer, out = build_trainer(tmp_path)
    trainer.write_stats(trainer.compute_stats())
    n_at_submit = len(trainer.recorder.loss_trace())
    before = {k: t.clone() for k, t in trainer.state.params.items()}
    step = trainer.state.step
    gate = _held(trainer.save)
    live = trainer.state.params["Encoder.FC0.kernel"]
    trainer.state, losses = trainer.train_chunk(trainer.state, 5)  # in place
    assert trainer.state.params["Encoder.FC0.kernel"] is live
    assert not torch.equal(live, before["Encoder.FC0.kernel"])
    trainer.recorder.append_train_losses(np.full(64, 123.0, np.float32))
    gate.set()
    get_artifact_writer().drain()
    z = np.load(os.path.join(out, "losses.npz"))
    assert z["VAE Loss"].shape[0] == n_at_submit and not np.any(z["VAE Loss"] == 123.0)
    for saved in (load_model_pkl(os.path.join(out, "model.pkl")), restore_checkpoint(out)):
        for k, t in before.items():
            assert torch.equal(saved.params[k], t), k
    assert restore_checkpoint(out).step == step


def test_grid_save_all_snapshots_at_submit_time(tmp_path):
    cfg = make_cfg(tmp_path)
    trainer = GridTrainer(cfg, seeds=[2])
    out = make_output_dir("snap_seed2", True, cfg, data_dir=str(tmp_path))
    trainer.compute_and_write_stats()
    n_at_submit = len(trainer.recorders[0].loss_trace())
    before = {k: t.clone() for k, t in trainer.states[0].params.items()}
    gate = _held(lambda: trainer.save_all([out]))
    trainer.run_chunk(5)  # updates the row's state in place
    trainer.recorders[0].append_train_losses(np.full(64, 123.0, np.float32))
    gate.set()
    get_artifact_writer().drain()
    z = np.load(os.path.join(out, "losses.npz"))
    assert z["VAE Loss"].shape[0] == n_at_submit and not np.any(z["VAE Loss"] == 123.0)
    with open(os.path.join(out, "ckpt_aux.pkl"), "rb") as f:
        aux = pickle.load(f)
    assert sum(len(np.asarray(x).reshape(-1)) for x in aux["recorder"]["vae_losses"]) \
        == n_at_submit
    saved = restore_checkpoint(out)
    assert saved.step == 0
    for k, t in before.items():
        assert torch.equal(saved.params[k], t), k


def test_solo_train_failure_still_flushes_queued_artifacts(tmp_path):
    """A crash in the loop propagates unmasked, and the saves queued before
    it reach the disk without a drain by the caller."""
    trainer, out = build_trainer(tmp_path)
    trainer.write_stats(trainer.compute_stats())
    gate = _held(trainer.save)

    def boom():
        gate.set()
        raise RuntimeError("device lost")

    trainer.train_distribution = boom
    with pytest.raises(RuntimeError, match="device lost"):
        trainer.train()
    files = set(os.listdir(out))
    assert {"losses.npz", "model.pkl", "ckpt.pt", "ckpt_meta.json"} <= files


def test_grid_train_returns_with_artifacts_durable(tmp_path):
    cfg = make_cfg(tmp_path, 120, "--n_print", "60", "--n_plot", "60")
    trainer = GridTrainer(cfg, seeds=[2, 3])
    outs = [make_output_dir(f"dur_seed{s}", True, cfg, data_dir=str(tmp_path)) for s in (2, 3)]
    trainer.train(outs)
    assert get_artifact_writer()._q.unfinished_tasks == 0
    for out in outs:
        files = set(os.listdir(out))
        assert {"losses.npz", "model.pkl", "ckpt.pt"} <= files
        assert any(f.startswith("output_") and f.endswith(".png") for f in files)
        assert restore_checkpoint(out).step == 119  # the last in-loop save, at step 119


def test_a_failed_write_fails_the_run(tmp_path, monkeypatch):
    from vae_training_tpu_torch.train import loop

    def no_disk(*a, **k):
        raise OSError("no space left on device")

    monkeypatch.setattr(loop, "save_model_pkl", no_disk)
    trainer, _ = build_trainer(tmp_path, num_batches=30)
    with pytest.raises(RuntimeError, match="artifact write failed") as ei:
        trainer.train()
        trainer.save(final=True)
    assert isinstance(ei.value.__cause__, OSError)
