"""``--ckpt_backend orbax`` on the port: a torch.distributed.checkpoint (DCP)
directory, after the JAX package's orbax backend, on the CPU.

  - a DCP round trip is bitwise, with f32 and with bf16 moments, the
    64-bit seeds and the parameters' order included;
  - the directory swap is safe under preemption: a set-aside ``.old`` is
    read, counted and cleaned up by the next save, and promoted rather than
    deleted when a second kill lands inside that save
    (tests/test_checkpoint_and_export.py:308-430);
  - one sequence of saves (the default backend at step 10, the directory
    backend at 20, a stale save at 15) restores step 20 through both
    packages' ``restore_checkpoint``, and the stale save changes nothing;
  - through the CLI, 15 steps and ``--resume`` to 40 equal 40 steps,
    bitwise, in both moment dtypes; a default-backend run resumes under
    ``orbax``;
  - ``--seed_grid`` and ``--multihost`` with ``orbax`` raise, as in JAX.
"""

import os
import pickle

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu.config import RunConfig as JaxRunConfig  # noqa: E402
from vae_training_tpu.data import get_dataset as jax_get_dataset  # noqa: E402
from vae_training_tpu.runio import checkpoint as jax_ck  # noqa: E402
from vae_training_tpu.runio import make_output_dir as jax_make_output_dir  # noqa: E402
from vae_training_tpu.train import Trainer as JaxTrainer  # noqa: E402
from vae_training_tpu_torch._scripts.run import main  # noqa: E402
from vae_training_tpu_torch.config import parse_arguments  # noqa: E402
from vae_training_tpu_torch.runio import checkpoint as ck  # noqa: E402
from vae_training_tpu_torch.train.state import TrainState  # noqa: E402

NAMES = ["Encoder.FC1.kernel", "Encoder.FC0.bias", "Decoder.FC0.kernel", "epsilon_p"]
ROW = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
       "-ow", "--latent_dim", "6", "--padding_dim", "3", "-dd", "3", "--epsilon", "-1",
       "-tdv", "-ds", "2", "-lr", "1e-3", "--batch_size", "50", "--device", "cpu",
       "--n_print", "10", "--n_plot", "20"]


def _state(step, adam_dtype="f32", seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"Encoder.FC1.kernel": (5, 4), "Encoder.FC0.bias": (4,),
              "Decoder.FC0.kernel": (4, 5), "epsilon_p": ()}
    st = TrainState.create({n: torch.randn(shapes[n], generator=g) for n in NAMES},
                           data_seed=2**64 - 3, model_seed=12345, adam_dtype=adam_dtype)
    for tree in (st.m, st.v):
        for k, t in tree.items():
            t.copy_(torch.randn(t.shape, generator=g).abs())
    st.step = st.count = step
    return st


def _same_state(a, b):
    assert (a.step, a.count, a.data_seed, a.model_seed) == \
        (b.step, b.count, b.data_seed, b.model_seed)
    for tree in ("params", "m", "v"):
        ta, tb = getattr(a, tree), getattr(b, tree)
        assert list(ta) == list(tb), tree
        for k in ta:
            assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), (tree, k)


@pytest.mark.parametrize("adam_dtype", ["f32", "bf16"])
def test_dcp_round_trip_is_bitwise(tmp_path, adam_dtype):
    st = _state(7, adam_dtype)
    path = ck.save_checkpoint_dcp(str(tmp_path), st, extra_meta={"current_epsilon": -2.5},
                                  aux={"eval_counter": 3})
    assert path == str(tmp_path / ck.DCP_NAME) and os.path.isdir(path)
    assert not (tmp_path / ck.CKPT_NAME).exists() and ck.checkpoint_exists(str(tmp_path))
    got = ck.restore_checkpoint(str(tmp_path))
    _same_state(got, st)
    assert got.adam_dtype == adam_dtype
    assert ck.read_checkpoint_meta(str(tmp_path)) == {
        "step": 7, "backend": "dcp", "adam_dtype": adam_dtype, "current_epsilon": -2.5}
    assert ck.restore_checkpoint_aux(str(tmp_path)) == {"eval_counter": 3, "step": 7}


def test_dcp_swap_is_preemption_safe(tmp_path):
    d = str(tmp_path)
    ck.save_checkpoint_dcp(d, _state(7))
    path = os.path.join(d, ck.DCP_NAME)
    os.replace(path, path + ".old")  # killed mid-swap: old set aside, new not installed
    assert ck.checkpoint_exists(d)
    assert ck.restore_checkpoint(d).step == 7
    ck.save_checkpoint_dcp(d, _state(8))  # cleans the leftover, installs normally
    assert os.path.exists(path) and not os.path.exists(path + ".old")
    assert not os.path.exists(path + ".new")
    assert ck.restore_checkpoint(d).step == 8


def test_a_set_aside_dcp_dir_is_promoted_not_deleted(tmp_path, monkeypatch):
    """Only ``.old`` survives a kill mid-swap; the next save dies inside the
    write: a restorable checkpoint must remain."""
    import torch.distributed.checkpoint as dcp

    d = str(tmp_path)
    st = _state(5)
    ck.save_checkpoint_dcp(d, st)
    path = os.path.join(d, ck.DCP_NAME)
    os.replace(path, path + ".old")

    def preempted(*a, **k):
        raise RuntimeError("preempted during save")

    monkeypatch.setattr(dcp, "save", preempted)
    with pytest.raises(RuntimeError, match="preempted"):
        ck.save_checkpoint_dcp(d, _state(6))
    assert os.path.isdir(path)  # promoted back before the write
    assert ck.checkpoint_exists(d)
    _same_state(ck.restore_checkpoint(d), st)


def _jax_trainer(tmpdir, name):
    cfg = JaxRunConfig(name=name, dataset="linear_gaussian", encoder_layer_sizes="",
                       layer_sizes="", latent_dimension=6, padding_dim=3,
                       dataset_dimension=3, num_batches=40, batch_size=50,
                       learning_rate=1e-3, epsilon=-1.0, tunable_decoder_var=True,
                       dataset_seed=2, overwrite=True, tqdm=False, data_dir=tmpdir,
                       kernels="xla").validate()
    out = jax_make_output_dir(cfg.name, cfg.overwrite, cfg, data_dir=cfg.data_dir)
    return JaxTrainer(cfg, jax_get_dataset(cfg.dataset, cfg.dataset_seed, cfg), out), out


def test_one_save_sequence_restores_the_same_step_in_both_packages(tmp_path):
    """The default backend at step 10, the directory backend at 20, then a
    stale save at 15 (a queued background save landing late): both packages
    restore step 20, from their directory checkpoint."""
    trainer, jax_dir = _jax_trainer(str(tmp_path / "jax"), "seq")
    states = {}
    s = trainer.state
    for step in (10, 15, 20):
        s, _ = trainer.fns.train_chunk(s, step - int(s.step))
        states[step] = jax.device_get(s)
    jax_ck.save_checkpoint(jax_dir, states[10])
    jax_ck.save_checkpoint_orbax(jax_dir, states[20])
    jax_ck.save_checkpoint_async(jax_dir, states[15]).result()
    jax_ck.wait_for_pending_saves()
    jax_step = int(jax_ck.restore_checkpoint(jax_dir, states[10]).step)

    torch_dir = str(tmp_path / "torch")
    os.makedirs(torch_dir)
    ck.save_checkpoint(torch_dir, _state(10))
    ck.save_checkpoint_dcp(torch_dir, _state(20, seed=1))
    ck.save_checkpoint(torch_dir, _state(15))  # stale: the guard drops it
    _same_state(ck.restore_checkpoint(torch_dir), _state(20, seed=1))
    assert jax_step == 20
    assert [jax_ck.read_checkpoint_meta(jax_dir)[k] for k in ("step", "backend")] == \
        [20, "orbax"]
    assert [ck.read_checkpoint_meta(torch_dir)[k] for k in ("step", "backend")] == [20, "dcp"]
    # and the reverse: a stale directory save after a newer default one
    ck.save_checkpoint(torch_dir, _state(30, seed=2))
    ck.save_checkpoint_dcp(torch_dir, _state(25))
    _same_state(ck.restore_checkpoint(torch_dir), _state(30, seed=2))


def _cli(tmp_path, name, steps, *extra):
    return main(parse_arguments([name, *ROW, "--num_batches", str(steps),
                                 "--data_dir", str(tmp_path), *extra]))


def _same_run(a, b):
    za, zb = np.load(a / "losses.npz"), np.load(b / "losses.npz")
    assert za.files == zb.files
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with open(a / "model.pkl", "rb") as f:
        pa = pickle.load(f)
    with open(b / "model.pkl", "rb") as f:
        pb = pickle.load(f)
    assert pickle.dumps(pa) == pickle.dumps(pb)
    _same_state(ck.restore_checkpoint(str(a)), ck.restore_checkpoint(str(b)))


@pytest.mark.parametrize("adam_dtype", ["f32", "bf16"])
def test_dcp_resume_15_plus_25_equals_40(tmp_path, adam_dtype):
    flags = ["--ckpt_backend", "orbax", "--adam_dtype", adam_dtype]
    assert _cli(tmp_path, "whole", 40, *flags) == 0
    assert _cli(tmp_path, "part", 15, *flags) == 0
    assert (tmp_path / "part" / ck.DCP_NAME).is_dir()
    assert not (tmp_path / "part" / ck.CKPT_NAME).exists()
    assert _cli(tmp_path, "part", 40, *flags, "--resume", str(tmp_path / "part")) == 0
    assert ck.read_checkpoint_meta(str(tmp_path / "part"))["backend"] == "dcp"
    _same_run(tmp_path / "whole", tmp_path / "part")
    state = ck.restore_checkpoint(str(tmp_path / "part"))
    want = torch.bfloat16 if adam_dtype == "bf16" else torch.float32
    assert state.m["Encoder.FC0.kernel"].dtype == want


def test_a_default_backend_run_resumes_under_orbax(tmp_path):
    assert _cli(tmp_path, "whole", 40) == 0
    assert _cli(tmp_path, "part", 15) == 0
    assert _cli(tmp_path, "part", 40, "--ckpt_backend", "orbax",
                "--resume", str(tmp_path / "part")) == 0
    meta = ck.read_checkpoint_meta(str(tmp_path / "part"))
    assert meta["backend"] == "dcp" and meta["step"] == 40
    _same_run(tmp_path / "whole", tmp_path / "part")


@pytest.mark.parametrize("extra,exc,match", [
    (["--seed_grid", "2,3"], NotImplementedError,
     "--seed_grid checkpoints every row through the msgpack"),
    (["--multihost"], ValueError, "--ckpt_backend orbax does not compose with --multihost"),
], ids=["seed_grid", "multihost"])
def test_orbax_refusals_mirror_the_jax_package(tmp_path, extra, exc, match):
    with pytest.raises(exc, match=match):
        _cli(tmp_path, "r", 4, "--ckpt_backend", "orbax", *extra)
    assert not os.listdir(tmp_path)
