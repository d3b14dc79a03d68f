"""The port's multi-process entry points in gloo ranks on the CPU: the seed
grid and the grouped sweep sharded over ranks, the CLI's ``--multihost``,
and the refusals (tests/torch_parallel_ranks.py runs the ranks; every join
has its own timeout).

  - ``--seed_grid 2,3,4,5 --mesh dp=N --multihost`` over 2 and 4 ranks
    (K6a's plain version on the CPU): every row's losses.npz, model.pkl and
    checkpoint equal the one-process ``--seed_grid 2,3,4,5`` run's bitwise;
    each rank wrote exactly its own rows' artifacts, and its console lines
    carry its ``[pK] `` prefix;
  - ``vae-sweep-torch linear --grouped --mesh dp=2`` over 2 ranks: the 21
    rows padded to 22 (rank 1 launches over 11 rows, one a discarded pad),
    every run bitwise the one-process grouped sweep's, each rank writing
    only its real rows;
  - the JAX package's four grid refusals (tp, dp_dcn, a seed count that
    does not divide, a multihost grid without a mesh spanning every
    process) and ``check_shared_fs``'s two forms with its text;
  - the CLI with ``--multihost --mesh dp=2`` over 2 ranks at linear row 1:
    only rank 0 writes args.json, losses.npz, model.pkl and the checkpoint;
    their keys and shapes equal the JAX CLI's ``--mesh dp=2``; ``--resume``
    over 2 ranks equals the uninterrupted 2-rank run bitwise;
  - the conv VAE in epoch mode through the CLI with ``--mesh dp=2`` over 2
    ranks against the one-process run.
"""

import json
import os
import pickle
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu._scripts.run import main as jax_main  # noqa: E402
from vae_training_tpu.config import parse_arguments as jax_parse  # noqa: E402
from vae_training_tpu_torch._scripts import sweep  # noqa: E402
from vae_training_tpu_torch._scripts.run import cli  # noqa: E402
from vae_training_tpu_torch.parallel.dryrun import spawn_ranks  # noqa: E402
from vae_training_tpu_torch.runio.checkpoint import restore_checkpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_parallel_ranks.py")
ROW1 = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
        "-ow", "--latent_dim", "20", "--padding_dim", "9", "-dd", "3", "--epsilon", "-1",
        "-tdv", "-lr", "1e-3", "--n_print", "10", "--n_plot", "10"]
SEEDS = [2, 3, 4, 5]


def _ranks(n, scenario, workdir, *argv):
    """Run ``scenario`` in n ranks; every rank's stdout (all must exit 0)."""
    results = spawn_ranks(n, [sys.executable, RANKS, scenario, str(workdir), *argv],
                          timeout=120, cwd=REPO, env={"PYTHONPATH": REPO})
    for r, (rc, _, err) in enumerate(results):
        assert rc == 0, f"rank {r} of {scenario} failed:\n{err[-4000:]}"
    return [out for _, out, _ in results]


def _writes(workdir, n):
    return [{tuple(w) for w in json.load(open(os.path.join(workdir, f"writes_rank{r}.json")))}
            for r in range(n)]


def _same_run(a, b):
    za, zb = np.load(os.path.join(a, "losses.npz")), np.load(os.path.join(b, "losses.npz"))
    assert za.files == zb.files, (a, b)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{a} {k}")
    with open(os.path.join(a, "model.pkl"), "rb") as f:
        pa = pickle.load(f)
    with open(os.path.join(b, "model.pkl"), "rb") as f:
        pb = pickle.load(f)
    assert _shapes(pa) == _shapes(pb)
    for x, y in zip(_leaves(pa), _leaves(pb)):
        np.testing.assert_array_equal(x, y, err_msg=a)
    sa, sb = restore_checkpoint(a), restore_checkpoint(b)
    assert (sa.step, sa.count) == (sb.step, sb.count)
    for tree in ("params", "m", "v"):
        for k, t in getattr(sa, tree).items():
            assert torch.equal(t, getattr(sb, tree)[k]), (a, tree, k)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return np.shape(tree)


@pytest.fixture(scope="module")
def grid_reference(tmp_path_factory):
    """The one-process --seed_grid 2,3,4,5 run (K6a's plain version)."""
    ref = tmp_path_factory.mktemp("grid_ref")
    assert cli(["g", *ROW1, "--num_batches", "20", "--device", "cpu", "--data_dir", str(ref),
                "--seed_grid", ",".join(map(str, SEEDS))]) == 0
    return ref


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_grid_rows_equal_the_unsharded_grid(tmp_path, grid_reference, n):
    outs = _ranks(n, "cli", tmp_path, "g", *ROW1, "--num_batches", "20", "--device", "cpu",
                  "--data_dir", str(tmp_path / "runs"), "--seed_grid",
                  ",".join(map(str, SEEDS)), "--mesh", f"dp={n}", "--multihost")
    for seed in SEEDS:
        _same_run(str(grid_reference / f"g_seed{seed}"),
                  str(tmp_path / "runs" / f"g_seed{seed}"))
    k = len(SEEDS) // n
    for r, (writes, out) in enumerate(zip(_writes(tmp_path, n), outs)):
        mine = SEEDS[r * k:(r + 1) * k]
        assert writes == {(kind, f"g_seed{s}") for s in mine
                          for kind in ("losses.npz", "model.pkl", "checkpoint")}, r
        assert f"[p{r}] [kernels] plain: K6a's plain version on the CPU, {k} rows a chunk" in out
        seeds_printed = set(map(int, re.findall(r"^\[p\d\] \[seed (\d+)\]", out, re.M)))
        assert seeds_printed == set(mine), (r, seeds_printed)
        assert not re.search(r"^\[seed ", out, re.M)


def test_grouped_sweep_pads_rows_and_discards_the_pads(tmp_path):
    ref = tmp_path / "ref"
    assert sweep.main(["linear", "--grouped", "--num_batches", "2", "--device", "cpu",
                       "--data_dir", str(ref)]) == 0
    outs = _ranks(2, "sweep", tmp_path, "linear", "--grouped", "--mesh", "dp=2",
                  "--num_batches", "2", "--device", "cpu", "--data_dir", str(tmp_path / "sh"))
    names = sorted(os.listdir(ref))
    assert len(names) == 21 and sorted(os.listdir(tmp_path / "sh")) == names
    for name in names:
        _same_run(str(ref / name), str(tmp_path / "sh" / name))
    # 21 rows padded to 22: rank 0 trains 11 real rows, rank 1 10 and a pad
    assert "[p0] [kernels] plain: K6a's plain version on the CPU, 11 rows a chunk" in outs[0]
    assert "[p1] [kernels] plain: K6a's plain version on the CPU, 11 rows a chunk" in outs[1]
    assert "ONE-LAUNCH linear: 7 rows × 3 seeds sharded over dp=2" in outs[0]
    w0, w1 = ({d for _, d in w} for w in _writes(tmp_path, 2))
    assert len(w0) == 11 and len(w1) == 10 and not w0 & w1 and w0 | w1 == set(names)


@pytest.mark.parametrize("mesh,match", [
    ("tp=2", "--seed_grid shards SEEDS over the mesh; use a pure dp spec"),
    ("dp_dcn=2,dp=1", "--seed_grid with dp_dcn makes no sense"),
])
def test_grid_refuses_tp_and_dp_dcn(tmp_path, mesh, match):
    with pytest.raises(ValueError, match=re.escape(match)):
        cli(["g", *ROW1, "--num_batches", "2", "--device", "cpu", "--data_dir", str(tmp_path),
             "--seed_grid", "2,3", "--mesh", mesh])


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("checks")
    _ranks(2, "checks", tmp)
    return [json.load(open(tmp / f"checks_rank{r}.json")) for r in range(2)]


def test_grid_refusals_over_two_ranks(checks):
    for got in checks:
        assert got["indivisible"] == ("--seed_grid with --mesh dp=2 needs the seed count "
                                      "to divide evenly; got 3 seeds")
        assert got["no mesh"] == ("--seed_grid under --multihost requires a dp mesh "
                                  "(--mesh dp=N): seed rows must shard across processes "
                                  "so each process owns and writes its own rows")
        assert got["not spanning"] == ("--seed_grid --multihost: the mesh must span every "
                                       "process (mesh covers processes [0] of 2); size dp "
                                       "to the global device count")


def test_check_shared_fs_raises_the_jax_text(checks):
    tail = (" Multi-process --resume/--state_dict requires the run directory on a SHARED "
            "filesystem mounted on every host — each process restores the checkpoint "
            "itself; divergent visibility would crash the missing process or silently "
            "fork the run.")
    for got in checks:
        assert got["shared one"] == (
            "multihost restore: the checkpoint at '/runs/r' is not uniformly visible "
            "across processes (visible to process(es) [0] but NOT to [1])." + tail)
        assert got["shared rows"] == (
            "multihost restore: the grid row checkpoints at '/runs' is not uniformly "
            "visible across processes (entry 1: visible to process(es) [0] but NOT to "
            "[1])." + tail)
        assert got["shared agree"] is None


def test_cli_multihost_writes_on_rank_zero_like_the_jax_cli(tmp_path):
    _ranks(2, "cli", tmp_path, "m", *ROW1, "--num_batches", "20", "--device", "cpu",
           "--data_dir", str(tmp_path / "d{rank}"), "--mesh", "dp=2", "--multihost")
    run = tmp_path / "d0" / "m"
    for f in ("args.json", "losses.npz", "model.pkl", "ckpt.pt", "ckpt_meta.json",
              "ckpt_aux.pkl"):
        assert (run / f).exists(), f
    assert not (tmp_path / "d1").exists() or not os.listdir(tmp_path / "d1")
    w0, w1 = _writes(tmp_path, 2)
    assert w0 == {(k, "m") for k in ("losses.npz", "model.pkl", "checkpoint")} and not w1
    cfg = jax_parse(["j", *ROW1, "--num_batches", "20", "--mesh", "dp=2",
                     "--data_dir", str(tmp_path / "jax")])
    cfg.tqdm = False
    assert jax_main(cfg) == 0
    zj, zp = np.load(tmp_path / "jax" / "j" / "losses.npz"), np.load(run / "losses.npz")
    assert sorted(zj.files) == sorted(zp.files)
    for k in zj.files:
        assert zj[k].shape == zp[k].shape, k
    with open(tmp_path / "jax" / "j" / "model.pkl", "rb") as f:
        pj = pickle.load(f)
    with open(run / "model.pkl", "rb") as f:
        pp = pickle.load(f)
    assert _shapes(pj) == _shapes(pp)


def test_cli_multihost_resume_equals_the_uninterrupted_run(tmp_path):
    common = [*ROW1, "--device", "cpu", "--data_dir", str(tmp_path), "--mesh", "dp=2",
              "--multihost"]
    _ranks(2, "cli", tmp_path, "full", *common, "--num_batches", "20")
    _ranks(2, "cli", tmp_path, "part", *common, "--num_batches", "12")
    _ranks(2, "cli", tmp_path, "resumed", *common, "--num_batches", "20", "--resume",
           str(tmp_path / "part"))
    _same_run(str(tmp_path / "full"), str(tmp_path / "resumed"))


def test_cli_epoch_mode_over_two_ranks(tmp_path):
    """The conv VAE in epoch mode through the CLI with ``--mesh dp=2`` over
    two ranks (the epoch chunk's dp branch) against the one-process run:
    the losses at tests/test_pallas_kernel.py's tolerance (2e-4), only rank
    0 speaking."""
    flags = ["--dataset", "image", "--image_size", "8", "--num_images", "64", "--num_epochs",
             "2", "--batch_size", "16", "--latent_dim", "4", "--conv_channels", "4|8", "-lr",
             "1e-3", "--epsilon", "-1", "-tdv", "-ow", "--device", "cpu", "--data_dir",
             str(tmp_path)]
    assert cli(["one", *flags]) == 0
    outs = _ranks(2, "cli", tmp_path, "two", *flags, "--mesh", "dp=2", "--multihost")
    assert ("[kernels] torch: plain PyTorch path (--mesh dp=2: data parallel over dp=2); "
            "eager (the CPU has no CUDA graphs), one epoch a chunk") in outs[0]
    assert "Completed Epoch 1" in outs[0] and "Completed Epoch" not in outs[1]
    za, zb = np.load(tmp_path / "one" / "losses.npz"), np.load(tmp_path / "two" / "losses.npz")
    assert za.files == zb.files and za["VAE Loss"].shape == (2 * 4 + 3,)
    np.testing.assert_allclose(zb["VAE Loss"], za["VAE Loss"], rtol=2e-4, atol=2e-4)
