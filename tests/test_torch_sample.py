"""The port's serving path (``vae-sample-torch``) against the JAX package's.

  - a JAX CLI run on the CPU is sampled by the JAX ``sample.py``; the port's
    ``load_run`` reads the same directory (its ``model.pkl``: a JAX run has
    no ``ckpt.pt``), and fed the JAX latents gives the same samples to
    rtol 1e-5 / atol 1e-6 (fp32 on both sides; summation order only);
  - the port's CLI round trip on its own run: shapes, finite values, the
    same ``--seed`` bitwise, another seed different, the figure, and the
    same samples from a copy of the directory holding only ``model.pkl``;
  - ``--device cuda`` without a card raises.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu._scripts.run import main as jax_run  # noqa: E402
from vae_training_tpu._scripts.sample import main as jax_sample  # noqa: E402
from vae_training_tpu.config import parse_arguments as jax_parse  # noqa: E402
from vae_training_tpu_torch._scripts.run import cli as port_run  # noqa: E402
from vae_training_tpu_torch._scripts.sample import load_run, main as port_sample  # noqa: E402

ROW = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
       "-ow", "--latent_dim", "6", "--padding_dim", "3", "-dd", "3", "--num_batches", "40",
       "--batch_size", "32", "-tdv", "--epsilon", "-1", "-ds", "2", "-lr", "1e-3",
       "--n_print", "20", "--n_plot", "20"]
SIGMOID_MLP = ["--dataset", "sigmoid", "--encoder_layer_sizes", "16", "--layer_sizes", "8|8",
               "-ow", "--latent_dim", "4", "--padding_dim", "2", "-dd", "3",
               "--num_batches", "20", "--batch_size", "16", "-tdv", "--epsilon", "-3",
               "--n_print", "10", "--n_plot", "10"]


@pytest.mark.parametrize("row", [ROW, SIGMOID_MLP], ids=["linear", "sigmoid_mlp"])
def test_port_samples_a_jax_run_like_the_jax_sampler(tmp_path, row):
    cfg = jax_parse(["srv", *row, "--kernels", "xla", "--data_dir", str(tmp_path)])
    cfg.tqdm = False
    assert jax_run(cfg) == 0
    run_dir = os.path.join(tmp_path, "srv")
    assert not os.path.exists(os.path.join(run_dir, "ckpt.pt"))
    out = os.path.join(tmp_path, "jax.npz")
    assert jax_sample([run_dir, "-n", "64", "-o", out, "--seed", "3"]) == 0
    ref = np.load(out)
    trainer = load_run(run_dir, device="cpu")
    samples, latents = trainer.sample_batch(0, 64, latents=ref["latents"])
    assert tuple(latents.shape) == ref["latents"].shape
    np.testing.assert_allclose(samples.numpy(), ref["samples"], rtol=1e-5, atol=1e-6)


def test_port_cli_round_trip(tmp_path):
    assert port_run(["srv", *ROW, "--device", "cpu", "--data_dir", str(tmp_path)]) == 0
    run_dir = os.path.join(tmp_path, "srv")
    out, png = os.path.join(tmp_path, "s.npz"), os.path.join(tmp_path, "tile.png")
    assert port_sample([run_dir, "-n", "128", "-o", out, "--png", png, "--device", "cpu"]) == 0
    z = np.load(out)
    assert z["samples"].shape == (128, 6) and z["latents"].shape == (128, 12)
    assert np.all(np.isfinite(z["samples"])) and np.all(np.isfinite(z["latents"]))
    assert os.path.getsize(png) > 0
    out2 = os.path.join(tmp_path, "s2.npz")
    assert port_sample([run_dir, "-n", "128", "-o", out2, "--device", "cpu"]) == 0
    np.testing.assert_array_equal(z["samples"], np.load(out2)["samples"])
    np.testing.assert_array_equal(z["latents"], np.load(out2)["latents"])
    out3 = os.path.join(tmp_path, "s3.npz")
    assert port_sample([run_dir, "-n", "128", "-o", out3, "--seed", "7", "--device", "cpu"]) == 0
    assert not np.array_equal(z["samples"], np.load(out3)["samples"])
    # the model.pkl fallback: the same parameters, so the same samples
    only_pkl = os.path.join(tmp_path, "pkl_only")
    os.makedirs(only_pkl)
    for f in ("args.json", "model.pkl"):
        shutil.copy(os.path.join(run_dir, f), only_pkl)
    out4 = os.path.join(tmp_path, "s4.npz")
    assert port_sample([only_pkl, "-n", "128", "-o", out4, "--device", "cpu"]) == 0
    np.testing.assert_array_equal(z["samples"], np.load(out4)["samples"])


def test_sampling_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert port_run(["srv", *ROW, "--device", "cpu", "--num_batches", "2",
                     "--data_dir", str(tmp_path)]) == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sample([os.path.join(tmp_path, "srv"), "-n", "4"])
