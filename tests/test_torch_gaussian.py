"""The port's ``gaussian`` dataset against the JAX package's ``GaussianDataset``.

  - ``score_host`` on the same numpy batch gives the JAX scores (rtol 1e-6:
    both are numpy on the same float32 input);
  - 100k draws have the moments of N(0, I) on the core and of
    N(0, noise_level·I) on the padding, and zero padding when the noise or
    the padding width is 0;
  - the CLI: no kernel takes the dataset (``auto`` routes to the torch
    path, ``cuda`` raises with both kernels' reasons), and a tiny run's
    banner, stat lines and ``losses.npz`` keys match the JAX CLI's.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu._scripts.run import main as jax_main  # noqa: E402
from vae_training_tpu.config import parse_arguments as jax_parse  # noqa: E402
from vae_training_tpu.data import GaussianDataset as JaxGaussian  # noqa: E402
from vae_training_tpu_torch._scripts.run import cli  # noqa: E402
from vae_training_tpu_torch.data import GaussianDataset, get_dataset  # noqa: E402
from vae_training_tpu_torch.config import parse_arguments  # noqa: E402

FLAGS = ["--dataset", "gaussian", "-dd", "3", "--padding_dim", "4", "--latent_dim", "5",
         "--encoder_layer_sizes", "", "--layer_sizes", "", "-ow", "--batch_size", "20",
         "--num_batches", "3", "--n_print", "2", "--n_plot", "2", "-dn", "0.1"]


@pytest.mark.parametrize("dim,pad,n", [(3, 4, 1000), (3, 0, 50), (1, 2, 7)])
def test_score_host_matches_jax(dim, pad, n):
    batch = np.random.RandomState(dim * 10 + pad).randn(n, dim + pad).astype(np.float32)
    got = GaussianDataset(dim, pad).score_host(batch)
    ref = JaxGaussian(dim=dim, padding_dim=pad).score_host(batch)
    assert list(got) == list(ref)
    assert isinstance(got["Squared Norm of padding dimensions"], float)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-12, err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
    # score() of a tensor is score_host of its numpy copy
    tensor_score = GaussianDataset(dim, pad).score(torch.as_tensor(batch))
    for k in ref:
        np.testing.assert_array_equal(tensor_score[k], got[k])


def test_moments_of_100k_draws():
    ds = GaussianDataset(3, 4, noise_level=0.25)
    x = ds.sample(12345, 7, 100_000).double()
    assert x.shape == (100_000, 7) and x.dtype == torch.float64
    core, pad = x[:, :3], x[:, 3:]
    # 100k draws: the mean's standard error 0.003, the variance's 0.0045
    assert core.mean(0).abs().max() < 0.015 and (core.var(0) - 1).abs().max() < 0.025
    assert pad.mean(0).abs().max() < 0.008 and (pad.var(0) / 0.25 - 1).abs().max() < 0.025
    cov = torch.cov(x.T)
    assert (cov - torch.diag(torch.diag(cov))).abs().max() < 0.015
    # pure function of (seed, step): the same draw twice, another step differs
    assert torch.equal(ds.sample(12345, 7, 100), ds.sample(12345, 7, 100))
    assert not torch.equal(ds.sample(12345, 7, 100), ds.sample(12345, 8, 100))


@pytest.mark.parametrize("noise,pad", [(0.0, 4), (0.5, 0)])
def test_zero_padding_without_noise_or_width(noise, pad):
    ds = GaussianDataset(3, pad, noise_level=noise)
    x = ds.sample(1, 0, 256)
    assert x.shape == (256, 3 + pad)
    assert torch.count_nonzero(x[:, 3:]) == 0
    assert torch.equal(x[:, :3], GaussianDataset(3, 0).sample(1, 0, 256))


def test_registry_maps_the_flags():
    cfg = parse_arguments(["g", *FLAGS, "--device", "cpu"])
    ds = get_dataset("gaussian", 5, cfg)
    assert isinstance(ds, GaussianDataset)
    assert (ds.dim, ds.padding_dim, ds.noise_level, ds.dimension) == (3, 4, 0.1, 7)


def test_no_kernel_takes_it(tmp_path, capsys):
    assert cli(["a", *FLAGS, "--device", "cpu", "--data_dir", str(tmp_path)]) == 0
    assert "[kernels] torch: plain PyTorch path (the fused kernel supports the " \
           "linear_gaussian and sigmoid datasets)" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="linear kernel: .*; MLP kernel: "):
        cli(["c", *FLAGS, "--device", "cpu", "--kernels", "cuda", "--data_dir", str(tmp_path)])


def _captured(fn):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert fn() == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gaussian")
    saved = os.environ.get("VAE_TPU_COMPILE_CACHE")
    os.environ["VAE_TPU_COMPILE_CACHE"] = ""  # no persistent XLA cache outside the test dir
    try:
        cfg = jax_parse(["j", *FLAGS, "--kernels", "xla", "--data_dir", str(root)])
        jax_out = _captured(lambda: jax_main(cfg))
    finally:
        if saved is None:
            os.environ.pop("VAE_TPU_COMPILE_CACHE")
        else:
            os.environ["VAE_TPU_COMPILE_CACHE"] = saved
    port_out = _captured(lambda: cli(["p", *FLAGS, "--device", "cpu", "--data_dir", str(root)]))
    return {"jax": (jax_out, root / "j"), "port": (port_out, root / "p")}


def test_banner_matches_the_jax_cli(runs):
    # the banner spans lines where numpy wraps an array
    lines = {pkg: re.findall(r"^Score for real data: (\{.*?\})$", out, re.M | re.S)
             for pkg, (out, _) in runs.items()}
    assert len(lines["jax"]) == len(lines["port"]) == 1
    keys = re.compile(r"'([^']+)': ")
    assert keys.findall(lines["port"][0]) == keys.findall(lines["jax"][0]) == [
        "Squared Norm of padding dimensions", "ground truth eigenvalue", "learnt eigenvalue"]
    # the values' shape: a float, then two arrays of the ambient dimension
    number = re.compile(r"-?\d+\.\d*(?:e[-+]?\d+)?")
    shape = {pkg: number.sub("#", re.sub(r"\s+", "", line[0])) for pkg, line in lines.items()}
    assert shape["port"] == shape["jax"]
    assert shape["jax"].count("array([") == 2 and shape["jax"].count("#") == 1 + 2 * 7


def test_stat_lines_match_the_jax_cli(runs):
    rows = {pkg: [line.split(" | ")[::2] for line in re.findall(
        r"^Batch \| \d+ \| (.*)$", out, re.M)] for pkg, (out, _) in runs.items()}
    assert len(rows["jax"]) == 2
    assert rows["port"] == rows["jax"]
    assert rows["jax"][0] == ["VAE Loss", "KL divergence", "mse",
                              "Squared Norm of padding dimensions"]


def test_losses_npz_matches_the_jax_cli(runs):
    z = {pkg: np.load(d / "losses.npz") for pkg, (_, d) in runs.items()}
    assert z["port"].files == z["jax"].files
    for k in ("ground truth eigenvalue", "learnt eigenvalue"):
        assert z["port"][k].shape == z["jax"][k].shape == (2, 7), k
    np.testing.assert_array_equal(z["port"]["ground truth eigenvalue"], np.ones((2, 7)))
