"""A run killed in the middle of a checkpoint save resumes bitwise, on the CPU.

A supervised row's deadline (``vae-sweep-torch --isolate --row_timeout``)
ends its process wherever it is, and on the card the writer thread can sit
between two renames of a save for a whole chunk: the state, the aux and
the meta of a save are each written atomically, not jointly. Here a save
dies at its k-th rename, and nothing is written after it; the run resumed
in place (``--resume <its dir>``) must end equal to the uninterrupted run,
bitwise (losses.npz, model.pkl, the final state), with either backend and
at either save of a step (the between-chunk save of ``--checkpoint_every``
and that step's event save, which share the step). ``runio/checkpoint.py``
``restore_run`` picks the newest save whose three parts are on disk.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch._scripts.run import main  # noqa: E402
from vae_training_tpu_torch.config import parse_arguments  # noqa: E402
from vae_training_tpu_torch.runio import checkpoint as ck  # noqa: E402
from vae_training_tpu_torch.train import loop  # noqa: E402

ROW = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
       "--latent_dim", "6", "--padding_dim", "3", "-dd", "3", "--epsilon", "-1", "-tdv",
       "-ds", "2", "-lr", "1e-3", "--batch_size", "50", "--device", "cpu", "--n_print", "10",
       "--n_plot", "20", "--checkpoint_every", "20", "--num_batches", "60"]


class _Killed(BaseException):
    """The process died here."""


def _run(data_dir, name, *extra):
    return main(parse_arguments([name, *ROW, "--data_dir", str(data_dir), *extra]))


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    d = tmp_path_factory.mktemp("whole")
    for backend in ("msgpack", "orbax"):
        assert _run(d, backend, "-ow", "--ckpt_backend", backend) == 0
    return d


# (the save's events_fired_at_step, the rename it dies at): a torch.save save
# of a new step renames 3 files aside and installs 3 (the event save of the
# same step only installs 3); a DCP save sets the directory aside, installs
# the new one, then the aux and the meta
CASES = ([("msgpack", False, k) for k in range(1, 7)] + [("msgpack", True, k) for k in (1, 2, 3)]
         + [("orbax", False, k) for k in (1, 2, 3, 4)] + [("orbax", True, k) for k in (2, 4)])


@pytest.mark.parametrize("backend,fired,k", CASES,
                         ids=[f"{b}-{'event' if f else 'between_chunks'}-rename{k}"
                              for b, f, k in CASES])
def test_a_save_killed_at_any_rename_resumes_bitwise(tmp_path, whole, monkeypatch,
                                                     backend, fired, k):
    state = {"armed": False, "renames": 0, "dead": False}
    real_replace = os.replace

    def replace(src, dst):
        if state["dead"]:
            raise _Killed()
        if state["armed"]:
            state["renames"] += 1
            if state["renames"] == k:
                state["dead"] = True
                raise _Killed()
        return real_replace(src, dst)

    def arming(real):
        def save(dirname, st, extra_meta=None, aux=None):
            if state["dead"]:
                raise _Killed()
            if int(st.step) == 40 and (aux or {}).get("events_fired_at_step") == fired:
                state["armed"] = True
            return real(dirname, st, extra_meta=extra_meta, aux=aux)
        return save

    monkeypatch.setattr(os, "replace", replace)
    monkeypatch.setattr(loop, "save_checkpoint", arming(ck.save_checkpoint))
    monkeypatch.setattr(loop, "save_checkpoint_dcp", arming(ck.save_checkpoint_dcp))
    with pytest.raises(RuntimeError, match="background artifact write failed"):
        _run(tmp_path, "part", "-ow", "--ckpt_backend", backend)
    assert state["dead"]
    monkeypatch.undo()

    part = tmp_path / "part"
    assert _run(tmp_path, "part", "--ckpt_backend", backend, "--resume", str(part)) == 0
    ref = whole / backend
    za, zb = np.load(ref / "losses.npz"), np.load(part / "losses.npz")
    assert za.files == zb.files
    for key in za.files:
        np.testing.assert_array_equal(za[key], zb[key], err_msg=key)
    with open(ref / "model.pkl", "rb") as f:
        pa = pickle.load(f)
    with open(part / "model.pkl", "rb") as f:
        pb = pickle.load(f)
    assert pickle.dumps(pa) == pickle.dumps(pb)
    sa, sb = ck.restore_checkpoint(str(ref)), ck.restore_checkpoint(str(part))
    assert (sa.step, sa.count) == (sb.step, sb.count) == (60, 60)
    for tree in ("params", "m", "v"):
        for name, t in getattr(sa, tree).items():
            assert torch.equal(t, getattr(sb, tree)[name]), (tree, name)
