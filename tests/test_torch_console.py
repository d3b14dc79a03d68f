"""The port's console and ``losses.npz`` output against the JAX package's own.

Both CLIs run the sigmoid and sphere rows 1 for a few steps on the CPU (the
JAX package on its XLA path, the port on its plain path) and are compared:

  - the score columns of every stat line, the ``losses.npz`` key order and
    the "Score for real data" keys follow the JAX engine's order (its jitted
    programs return the dataset scores with sorted keys);
  - the banner's values print as the JAX engine prints them, 0-d float32
    arrays; the values themselves differ, since the two RNGs differ;
  - a solo run draws a tqdm bar on stderr, as the JAX engine does, and a
    sweep row, whose config sets ``tqdm=False`` as the JAX runner's does,
    draws none.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sweep as jax_sweep  # noqa: E402  (the repo-root alias of the JAX runner)
from vae_training_tpu._scripts.run import main as jax_main  # noqa: E402
from vae_training_tpu.config import parse_arguments as jax_parse  # noqa: E402
from vae_training_tpu_torch._scripts import sweep  # noqa: E402
from vae_training_tpu_torch._scripts.run import cli  # noqa: E402

ROWS = {
    "sigmoid": ["--dataset", "sigmoid", "--encoder_layer_sizes", "", "--layer_sizes", "",
                "-ow", "--latent_dim", "6", "--padding_dim", "3", "-dd", "3",
                "--epsilon", "-3", "-tdv", "-lr", "1e-4"],
    "sphere": ["--dataset", "sphere", "--encoder_layer_sizes", "200|200|200",
               "--layer_sizes", "200|200|200", "-ow", "--latent_dim", "6",
               "--padding_dim", "3", "-dd", "3", "--epsilon", "-3", "-tdv", "-lr", "1e-4"],
}
STEPS = ["--num_batches", "3", "--n_print", "2", "--n_plot", "2"]
BAR = re.compile(r"\d+/3 \[")  # tqdm's "n/total [elapsed<remaining" field


def _captured(fn):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn()
    assert rc == 0
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{row: {"jax"|"port": (stdout, stderr, run dir)}}."""
    root = tmp_path_factory.mktemp("console")
    saved = os.environ.get("VAE_TPU_COMPILE_CACHE")
    os.environ["VAE_TPU_COMPILE_CACHE"] = ""  # no persistent XLA cache outside the test dir
    try:
        got = {}
        for row, flags in ROWS.items():
            cfg = jax_parse(["j", *flags, *STEPS, "--kernels", "xla",
                             "--data_dir", str(root / row)])
            jax_out = _captured(lambda: jax_main(cfg))
            port_out = _captured(lambda: cli(["p", *flags, *STEPS, "--device", "cpu",
                                              "--data_dir", str(root / row)]))
            got[row] = {"jax": (*jax_out, root / row / "j"),
                        "port": (*port_out, root / row / "p")}
        return got
    finally:
        if saved is None:
            os.environ.pop("VAE_TPU_COMPILE_CACHE")
        else:
            os.environ["VAE_TPU_COMPILE_CACHE"] = saved


def stat_line_keys(out):
    """The keys of every "Batch | n | k | v | ..." line, in order."""
    lines = re.findall(r"Batch \| \d+ \| (.*)$", out, re.M)
    return [line.split(" | ")[::2] for line in lines]


def banner(out):
    (line,) = re.findall(r"^Score for real data: (.*)$", out, re.M)
    return line


@pytest.mark.parametrize("row", list(ROWS))
def test_console_columns_follow_the_jax_engine(runs, row):
    jax_keys = stat_line_keys(runs[row]["jax"][0])
    assert len(jax_keys) == 2 and jax_keys[0][:3] == ["VAE Loss", "KL divergence", "mse"]
    assert stat_line_keys(runs[row]["port"][0]) == jax_keys


@pytest.mark.parametrize("row", list(ROWS))
def test_losses_npz_key_order_follows_the_jax_engine(runs, row):
    jax_files = np.load(runs[row]["jax"][2] / "losses.npz").files
    assert np.load(runs[row]["port"][2] / "losses.npz").files == jax_files


@pytest.mark.parametrize("row", list(ROWS))
def test_banner_prints_as_the_jax_engine(runs, row):
    jax_line, port_line = banner(runs[row]["jax"][0]), banner(runs[row]["port"][0])
    keys = re.compile(r"'([^']+)': ")
    assert keys.findall(port_line) == keys.findall(jax_line)
    # the values' repr: 0-d float32 arrays, numbers aside
    value = re.compile(r"array\([^,()]+, dtype=float32\)")
    assert len(value.findall(jax_line)) == len(keys.findall(jax_line))
    assert value.sub("V", port_line) == value.sub("V", jax_line)


@pytest.mark.parametrize("row", list(ROWS))
def test_solo_run_draws_a_progress_bar_on_stderr(runs, row):
    for pkg in ("jax", "port"):
        out, err, _ = runs[row][pkg]
        assert BAR.search(err), pkg
        assert not BAR.search(out), pkg


def test_sweep_row_draws_no_progress_bar(tmp_path):
    ref = list(jax_sweep.sweep_configs("linear", "d", 2, "auto"))
    assert {c.tqdm for c in ref} == {False}
    out, err = _captured(lambda: sweep.main(
        ["linear", "--num_batches", "3", "--device", "cpu", "--shard", "20/21",
         "--data_dir", str(tmp_path)]))
    assert "[sweep] shard 20/21: 1 of 21 runs" in out
    assert re.search(r"^Batch \| 0 \| ", out, re.M)
    assert not BAR.search(err) and not BAR.search(out)
