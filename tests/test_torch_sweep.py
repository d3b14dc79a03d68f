"""The port's sweep runner (``vae-sweep-torch``) on the CPU, and the port's
independence from JAX.

  - ``sweep_configs`` equals the JAX runner's, row for row, for all three
    sweeps (21, 18 and 15 runs), and ``cfg_to_argv`` round-trips through
    the port's parser (tests/test_sweep_runner.py:13-36);
  - ``--grouped`` trains the linear and sigmoid sweeps as one plain K6a
    chunk per chunk on the CPU, and the sphere sweep as one plain K6b chunk
    per chunk (the one-launch path; counted);
  - ``--adam_dtype bf16`` runs the grouped sweep with bf16 moments;
  - ``--shard K/N`` partitions the row groups disjointly; ``--report``
    summarises; the unported flags raise naming their ROADMAP items;
  - no module of the port and nothing in chip_smoke.py imports ``jax``,
    ``flax``, ``optax`` or ``vae_training_tpu``.
"""

import ast
import os
import re

import pytest

torch = pytest.importorskip("torch")

import sweep as jax_sweep  # noqa: E402  (the repo-root alias of the JAX runner)
from vae_training_tpu_torch._scripts import sweep  # noqa: E402
from vae_training_tpu_torch.config import parse_arguments  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("name", "dataset", "encoder_layer_sizes", "layer_sizes", "latent_dimension",
          "padding_dim", "dataset_dimension", "num_batches", "batch_size", "epsilon",
          "tunable_decoder_var", "dataset_seed", "learning_rate", "data_dir", "overwrite",
          "kernels", "adam_dtype")


@pytest.mark.parametrize("which,rows", [("linear", 21), ("sigmoid", 18), ("sphere", 15)])
@pytest.mark.parametrize("num_batches", [None, 123])
def test_sweep_configs_match_the_jax_runner(which, rows, num_batches):
    ref = list(jax_sweep.sweep_configs(which, "d", num_batches, "auto"))
    got = list(sweep.sweep_configs(which, "d", num_batches, "auto", device="cpu"))
    assert len(got) == len(ref) == rows
    for a, b in zip(got, ref):
        for field in FIELDS:
            assert getattr(a, field) == getattr(b, field), (b.name, field)
        assert a.device == "cpu"
    assert sweep.SWEEP_SEEDS == jax_sweep.SWEEP_SEEDS
    assert (sweep.LINEAR_GRID, sweep.SIGMOID_GRID, sweep.SPHERE_GRID) == (
        jax_sweep.LINEAR_GRID, jax_sweep.SIGMOID_GRID, jax_sweep.SPHERE_GRID)


def test_cfg_to_argv_roundtrips_through_parser():
    for which in ("linear", "sigmoid", "sphere"):
        cfg = next(sweep.sweep_configs(which, "dd", 123, "torch", device="cpu"))
        parsed = parse_arguments(sweep.cfg_to_argv(cfg))
        for field in FIELDS + ("device", "checkpoint_every"):
            assert getattr(parsed, field) == getattr(cfg, field), (which, field)


def _dirs(data_dir):
    return sorted(d for d in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, d)))


@pytest.mark.parametrize("which,rows", [("linear", 21), ("sigmoid", 18)])
def test_grouped_sweep_is_one_plain_grid_chunk_per_chunk(tmp_path, capsys, which, rows):
    calls = k1.plain_grid_chunk.calls
    assert sweep.main([which, "--grouped", "--num_batches", "3", "--device", "cpu",
                       "--data_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    # chunks 0-2 and 2-3 (events at 0 and at the last step), every row in each
    assert k1.plain_grid_chunk.calls == calls + 2
    assert f"[kernels] plain: K6a's plain version on the CPU, {rows} rows a chunk" in out
    assert re.search(r"^\[sweep\] wall accounting: banners [\d.]+s, train chunks [\d.]+s, "
                     rf"stat evals [\d.]+s, plot\+save [\d.]+s over {rows} rows", out, re.M)
    assert f"[sweep] ONE-LAUNCH {which}: {rows // 3} rows × 3 seeds" in out
    names = sorted(c.name for c in sweep.sweep_configs(which, str(tmp_path), 3, "auto"))
    assert _dirs(tmp_path) == names
    for name in names:
        assert (tmp_path / name / "losses.npz").exists() and (tmp_path / name / "ckpt.pt").exists()
    # the report reads every run back; a missing run is reported and fails
    assert sweep.main([which, "--report", "--data_dir", str(tmp_path)]) == 0
    assert "rows converged" in capsys.readouterr().out
    os.remove(tmp_path / names[0] / "losses.npz")
    assert sweep.main([which, "--report", "--data_dir", str(tmp_path)]) == 1
    assert f"MISSING: ['{names[0]} (FileNotFoundError)']" in capsys.readouterr().out


def test_grouped_sweep_runs_with_bf16_moments(tmp_path, capsys):
    from vae_training_tpu_torch.runio import checkpoint as ck

    calls = k1.plain_grid_chunk.calls
    assert sweep.main(["linear", "--grouped", "--num_batches", "2", "--device", "cpu",
                       "--adam_dtype", "bf16", "--data_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert k1.plain_grid_chunk.calls == calls + 2
    assert re.search(r"^\[kernels\] plain: K6a's plain version on the CPU, 21 rows a chunk.* "
                     r"with bf16 Adam moments$", out, re.M)
    names = sorted(c.name for c in sweep.sweep_configs("linear", str(tmp_path), 2, "auto"))
    assert _dirs(tmp_path) == names
    for name in names:
        state = ck.restore_checkpoint(str(tmp_path / name))
        assert state.m["Encoder.FC0.kernel"].dtype == state.v["Decoder.FC0.kernel"].dtype \
            == torch.bfloat16
        assert state.m["Encoder.FC0.bias"].dtype == torch.float32


def test_grouped_sphere_sweep_trains_per_row_grids(tmp_path, capsys):
    """The sphere sweep's rows (here one shard: one row group, 3 seeds) train
    as one launch a chunk, K6b's plain version on the CPU."""
    from vae_training_tpu_torch.kernels import mlp_vae as k5

    calls = k5.plain_grid_chunk.calls
    assert sweep.main(["sphere", "--grouped", "--num_batches", "2", "--device", "cpu",
                       "--shard", "1/5", "--data_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert k5.plain_grid_chunk.calls == calls + 2  # chunks 0-1 and 1-2
    assert "one-launch unavailable" not in out
    assert "[kernels] plain: K6b's plain version on the CPU, 3 rows a chunk" in out
    assert "[sweep] ONE-LAUNCH sphere: 1 rows × 3 seeds" in out
    assert _dirs(tmp_path) == ["sphere_dd3_pd13_ld_8_eps-3", "sphere_dd3_pd13_ld_8_eps-3_seed24",
                               "sphere_dd3_pd13_ld_8_eps-3_seed48"]


def test_shards_partition_the_row_groups(tmp_path, capsys):
    seen = []
    for k in range(3):
        d = tmp_path / str(k)
        assert sweep.main(["linear", "--grouped", "--num_batches", "1", "--device", "cpu",
                           "--shard", f"{k}/3", "--data_dir", str(d)]) == 0
        seen.append(set(_dirs(d)))
    out = capsys.readouterr().out
    assert "[sweep] shard 1/3: 2 row groups [(3, 17, 20), (9, 3, 20)]" in out
    assert not (seen[0] & seen[1] or seen[0] & seen[2] or seen[1] & seen[2])
    assert set.union(*seen) == {c.name for c in sweep.sweep_configs("linear", "d", 1, "auto")}


def test_sequential_runs_in_process(tmp_path, capsys):
    assert sweep.main(["linear", "--num_batches", "2", "--device", "cpu", "--shard", "20/21",
                       "--data_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[sweep] shard 20/21: 1 of 21 runs" in out
    assert _dirs(tmp_path) == ["vae12linear_gaussian_20dim4"]
    assert "[kernels] torch: plain PyTorch path (device 'cpu' is not a CUDA device)" in out


@pytest.mark.parametrize("extra,exc,match", [
    (["--isolate"], NotImplementedError, "ROADMAP Queue 1 item 12"),
    (["--row_timeout", "60"], NotImplementedError, "ROADMAP Queue 1 item 12"),
    (["--retries", "1"], NotImplementedError, "ROADMAP Queue 1 item 12"),
    # --mesh is ported: in one process dp=2 is the JAX make_mesh error, and
    # it needs --grouped
    (["--grouped", "--mesh", "dp=2"], ValueError,
     r"Mesh \{'dp': 2\} needs 2 devices but only 1 available"),
    (["--mesh", "dp=2"], ValueError, "--mesh shards the rows of --grouped sweeps"),
])
def test_unported_flags_raise_naming_their_item(tmp_path, extra, exc, match):
    with pytest.raises(exc, match=match):
        sweep.main(["linear", "--device", "cpu", "--data_dir", str(tmp_path), *extra])
    assert not os.listdir(tmp_path)


def test_kernels_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="--kernels cuda requested but no fused kernel"):
        sweep.main(["linear", "--grouped", "--kernels", "cuda", "--device", "cpu",
                    "--num_batches", "1", "--data_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_imports_no_jax():
    """Every module of vae_training_tpu_torch and chip_smoke.py, read as
    source: no import of jax, flax, optax, the JAX package or the repo's
    tools/, anywhere in the file (inside functions too)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "vae_training_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    banned = {"jax", "jaxlib", "flax", "optax", "vae_training_tpu", "tools"}
    bad = [(os.path.relpath(f, REPO), mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in banned]
    assert not bad, bad
