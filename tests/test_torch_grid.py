"""Seed grids on the port, end to end on the CPU (``--device cpu``).

  - ``--seed_grid 2,3`` at the linear sweep's row 1: each row's losses.npz
    and model.pkl equal the solo CLI run with ``-ds 2`` / ``-ds 3`` bitwise
    (the counterpart of tests/test_grid.py:185), through K6a's plain
    version, one chunk over both rows;
  - a grid run to step 20, then ``--resume rows`` to 30, equals the
    uninterrupted grid bitwise (tests/test_grid.py:96);
  - a row that saved one event ahead rolls back through ``.prev`` and its
    trio is promoted (tests/test_grid.py:351);
  - the dispatcher's printed choice for MLP rows (K6b's plain version on
    the CPU), and ``--kernels cuda`` without a card raises;
  - the checkpoint helpers the roll-back uses.
"""

import os
import pickle
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch._scripts.run import cli  # noqa: E402
from vae_training_tpu_torch.config import parse_arguments  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.runio import checkpoint as ck  # noqa: E402
from vae_training_tpu_torch.train import TrainState  # noqa: E402
from vae_training_tpu_torch.train import step as torch_step  # noqa: E402
from vae_training_tpu_torch.train.grid import GridTrainer, row_dirs  # noqa: E402

ROW1 = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
        "-ow", "--latent_dim", "20", "--padding_dim", "9", "-dd", "3", "--epsilon", "-1",
        "-tdv", "-lr", "1e-3", "--device", "cpu", "--n_print", "10", "--n_plot", "10"]


def run(name, data_dir, *extra, num_batches=30):
    return cli([name, *ROW1, "--num_batches", str(num_batches), "--data_dir", str(data_dir),
                *extra])


def assert_same_run(dir_a, dir_b):
    za, zb = np.load(os.path.join(dir_a, "losses.npz")), np.load(os.path.join(dir_b, "losses.npz"))
    assert set(za.files) == set(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with open(os.path.join(dir_a, "model.pkl"), "rb") as f:
        pa = pickle.load(f)
    with open(os.path.join(dir_b, "model.pkl"), "rb") as f:
        pb = pickle.load(f)
    assert pa["state"]["step"] == pb["state"]["step"]
    for name in pa["target"]:
        for x, y in zip(_leaves(pa["target"][name]), _leaves(pb["target"][name])):
            np.testing.assert_array_equal(x, y, err_msg=name)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_grid_rows_equal_solo_cli_runs_bitwise(tmp_path, capsys):
    calls = k1.plain_grid_chunk.calls
    assert run("grid", tmp_path, "--seed_grid", "2,3") == 0
    out = capsys.readouterr().out
    # chunks 0-10, 10-20, 20-29, 29-30: one plain grid chunk each, both rows
    assert k1.plain_grid_chunk.calls == calls + 4
    assert "[kernels] plain: K6a's plain version on the CPU, 2 rows a chunk" in out
    for seed in (2, 3):
        assert re.search(rf"^\[seed {seed}\] Score for real data: \{{'Squared Norm", out, re.M)
        assert [int(b) for b in re.findall(rf"^\[seed {seed}\] Batch \| (\d+) \| VAE Loss",
                                           out, re.M)] == [0, 10, 20]
        d = tmp_path / f"grid_seed{seed}"
        for f in ("args.json", "losses.npz", "model.pkl", "ckpt.pt", "ckpt_meta.json",
                  "ckpt_aux.pkl", "output_0.png", "output_29.png"):
            assert (d / f).exists(), f
        assert run(f"solo{seed}", tmp_path, "-ds", str(seed)) == 0
        assert_same_run(tmp_path / f"solo{seed}", d)


def test_grid_resume_equals_uninterrupted_bitwise(tmp_path):
    assert run("full", tmp_path, "--seed_grid", "2,3") == 0
    assert run("part", tmp_path, "--seed_grid", "2,3", num_batches=20) == 0
    # resume every row in place (their own part_seed<N> dirs) to 30 steps
    assert run("part", tmp_path, "--seed_grid", "2,3", "--resume", "rows") == 0
    for seed in (2, 3):
        assert_same_run(tmp_path / f"full_seed{seed}", tmp_path / f"part_seed{seed}")


def test_grid_restore_rolls_back_a_skewed_row(tmp_path, capsys):
    """A kill between two rows' saves leaves row 0 one save event ahead:
    restore() rolls it back to its .prev checkpoint at the common step,
    promotes the .prev trio, and the finished run equals an uninterrupted
    one."""
    argv = ["g", *ROW1, "--num_batches", "40", "--data_dir", str(tmp_path), "--seed_grid", "2,3",
            "--n_plot", "20"]
    assert cli(["f", *argv[1:]]) == 0
    cfg = parse_arguments(argv)
    trainer = GridTrainer(cfg, [2, 3])
    outs = row_dirs(cfg, [2, 3], ["g_seed2", "g_seed3"], False)
    orig = trainer.compute_and_write_stats

    def dying_stats():
        if trainer.batchnum == 30:
            raise KeyboardInterrupt
        orig()

    trainer.compute_and_write_stats = dying_stats
    with pytest.raises(KeyboardInterrupt):
        trainer.train(outs)  # durable saves at step 20
    # the skew a kill leaves: row 0 flushed the next save event (step 40)
    row0 = ck.restore_checkpoint(outs[0])
    assert row0.step == 20
    row0.step = 40
    ck.save_checkpoint(outs[0], row0)
    assert ck.read_checkpoint_meta(outs[0])["step"] == 40
    assert ck.read_checkpoint_meta(outs[0], prev=True)["step"] == 20
    capsys.readouterr()

    cfg.resume = "rows"
    resumed = GridTrainer(cfg, [2, 3])
    resumed.restore(outs)
    assert "rolling back from step 40 to the grid's common step 20" in capsys.readouterr().out
    assert resumed.batchnum == 20 and resumed._skip_events_at == 20
    assert ck.read_checkpoint_meta(outs[0])["step"] == 20
    assert not os.path.exists(os.path.join(outs[0], ck.CKPT_NAME + ck.PREV_SUFFIX))
    resumed.train(outs)
    resumed.save_all(outs, final=True)
    for seed, out in zip((2, 3), outs):
        assert_same_run(tmp_path / f"f_seed{seed}", out)


def test_grid_restore_refuses_a_skew_without_prev(tmp_path):
    assert run("g", tmp_path, "--seed_grid", "2,3", num_batches=12) == 0
    d = tmp_path / "g_seed2"
    state = ck.restore_checkpoint(str(d))
    for f in os.listdir(d):
        if f.endswith(ck.PREV_SUFFIX):
            os.remove(d / f)
    state.step = 99
    ck.save_checkpoint(str(d), state)
    for f in os.listdir(d):
        if f.endswith(ck.PREV_SUFFIX):
            os.remove(d / f)
    with pytest.raises(ValueError, match="no retained previous checkpoint"):
        run("g", tmp_path, "--seed_grid", "2,3", "--resume", "rows", num_batches=12)


def test_mlp_seed_grid_prints_its_per_row_choice(tmp_path, capsys):
    from vae_training_tpu_torch.kernels import mlp_vae as k5

    calls, grid_calls = torch_step.train_chunk.calls, k5.plain_grid_chunk.calls
    assert cli(["s", "--dataset", "sphere", "--encoder_layer_sizes", "16|16",
                "--layer_sizes", "16", "-ow", "--latent_dim", "4", "--padding_dim", "2",
                "-dd", "3", "--epsilon", "-3", "-tdv", "--device", "cpu", "--n_print", "5",
                "--n_plot", "5", "--num_batches", "6", "--data_dir", str(tmp_path),
                "--seed_grid", "69,24"]) == 0
    out = capsys.readouterr().out
    assert ("[kernels] plain: K6b's plain version on the CPU, 2 rows a chunk, one plain "
            "chunk a row (device 'cpu' is not a CUDA device; 2 ReLU MLP VAE rows on sphere") in out
    assert k5.plain_grid_chunk.calls == grid_calls + 2  # chunks 0-5 and 5-6, both rows
    assert torch_step.train_chunk.calls == calls + 2 * 2  # one torch-path chunk a row each
    assert (tmp_path / "s_seed69" / "model.pkl").exists()
    assert (tmp_path / "s_seed24" / "losses.npz").exists()


@pytest.mark.parametrize("extra,exc,match", [
    (["--kernels", "cuda"], RuntimeError, "--kernels cuda requested but no fused kernel"),
    (["--seed_grid", "2,x"], ValueError, "comma-separated integers"),
    (["--seed_grid", "2,2"], ValueError, "repeats a seed"),
    (["--mesh", "dp=2"], NotImplementedError, "item 11"),
    (["--track_correlation"], NotImplementedError, "solo-run diagnostic"),
])
def test_grid_refuses_what_it_cannot_run(tmp_path, extra, exc, match):
    if torch.cuda.is_available() and "cuda" in extra:
        pytest.skip("this host has a CUDA device")
    args = ["--seed_grid", "2,3", *extra] if "--seed_grid" not in extra else extra
    with pytest.raises(exc, match=match):
        run("e", tmp_path, *args, num_batches=2)


def test_kernels_torch_grid_runs_row_by_row(tmp_path, capsys):
    assert run("t", tmp_path, "--seed_grid", "2,3", "--kernels", "torch",
               num_batches=12) == 0
    assert "[kernels] torch: plain PyTorch path, row by row for 2 rows (--kernels torch)" \
        in capsys.readouterr().out
    assert run("a", tmp_path, "--seed_grid", "2,3", num_batches=12) == 0
    for seed in (2, 3):
        assert_same_run(tmp_path / f"t_seed{seed}", tmp_path / f"a_seed{seed}")


def test_checkpoint_prev_helpers(tmp_path):
    def state(step):
        return TrainState(params={"w": torch.full((2,), float(step))}, m={"w": torch.zeros(2)},
                          v={"w": torch.zeros(2)}, count=step, step=step, data_seed=1,
                          model_seed=2)

    d = str(tmp_path)
    with pytest.raises(OSError):
        ck.restore_checkpoint_prev(d)
    ck.save_checkpoint(d, state(5), extra_meta={"current_epsilon": -1.0}, aux={"a": 1})
    ck.save_checkpoint(d, state(10), aux={"a": 2})
    assert ck.read_checkpoint_meta(d, prev=True)["current_epsilon"] == -1.0
    assert ck.restore_checkpoint_aux(d, prev=True) == {"a": 1, "step": 5}
    assert ck.restore_checkpoint_prev(d).step == 5
    ck.promote_prev_checkpoint(d)
    assert ck.read_checkpoint_meta(d)["step"] == 5
    assert ck.restore_checkpoint(d).step == 5
    assert not any(f.endswith(ck.PREV_SUFFIX) for f in os.listdir(d))
    ck.save_checkpoint(d, state(8))  # the step guard accepts saves again
    assert ck.restore_checkpoint(d).step == 8
