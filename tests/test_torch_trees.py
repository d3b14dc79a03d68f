"""``utils/trees.py``, ``--track_correlation`` and the logistic latent
against the JAX package:

  - ``tree_vdot``, ``tree_sq_norm``, ``correlation_ratio``,
    ``correlation_ratio_per_param`` and ``sin_theta_distance`` on the same
    numpy trees (the port's dotted names, the JAX package's nested flax
    dicts) agree to 1e-6 (float32 sums in the same leaf order; XLA and
    torch may sum a leaf's elements in another order), and the
    per-parameter keys are the JAX package's;
  - the CLI with ``--track_correlation``: the ``losses.npz`` keys equal the
    JAX CLI's on the same flags, the ratios are finite, a resumed run's
    ratios equal an uninterrupted run's, and ``--seed_grid`` refuses it
    with the JAX package's message (a non-gaussian latent too);
  - ``sample_latent``'s logistic draw is finite and of the right shape, and
    ``latent_likelihood`` matches ``jax.scipy.stats`` norm and logistic
    ``logpdf`` to 1e-6.
"""

import contextlib
import dataclasses
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.scipy.stats import logistic as jax_logistic  # noqa: E402
from jax.scipy.stats import norm as jax_norm  # noqa: E402
from vae_training_tpu import utils as jax_trees  # noqa: E402
from vae_training_tpu._scripts.run import main as jax_main  # noqa: E402
from vae_training_tpu.config import parse_arguments as jax_parse  # noqa: E402
from vae_training_tpu_torch._scripts.run import cli  # noqa: E402
from vae_training_tpu_torch.config import parse_arguments  # noqa: E402
from vae_training_tpu_torch.data import get_dataset  # noqa: E402
from vae_training_tpu_torch.runio import make_output_dir  # noqa: E402
from vae_training_tpu_torch.runio.export import _unflatten  # noqa: E402
from vae_training_tpu_torch.train.grid import GridTrainer  # noqa: E402
from vae_training_tpu_torch.train.loop import Trainer  # noqa: E402
from vae_training_tpu_torch.utils import trees  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"Decoder.FC0.bias": (12,), "Decoder.FC0.kernel": (20, 12),
          "Encoder.FC0.bias": (20,), "Encoder.FC0.kernel": (12, 20),
          "SigDecoder.FC0.kernel": (20, 12), "epsilon": (1,), "epsilon_p": (20,)}


def _trees(seed):
    rs = np.random.RandomState(seed)
    return [{k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(3)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_functions_match_jax(seed):
    opt, params, grads = _trees(seed)
    j_opt, j_params, j_grads = (_unflatten(t) for t in (opt, params, grads))
    np.testing.assert_allclose(float(trees.tree_vdot(params, grads)),
                               float(jax_trees.tree_vdot(j_params, j_grads)), **TOL)
    np.testing.assert_allclose(float(trees.tree_sq_norm(grads)),
                               float(jax_trees.tree_sq_norm(j_grads)), **TOL)
    np.testing.assert_allclose(float(trees.correlation_ratio(opt, params, grads)),
                               float(jax_trees.correlation_ratio(j_opt, j_params, j_grads)), **TOL)
    got = trees.correlation_ratio_per_param(opt, params, grads)
    want = jax_trees.correlation_ratio_per_param(j_opt, j_params, j_grads)
    assert list(got) == list(want)
    assert "Decoder/FC0/kernel" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL, err_msg=k)
    # tensors on either side take the same path
    as_t = {k: torch.as_tensor(v) for k, v in opt.items()}
    assert float(trees.correlation_ratio(as_t, params, grads)) == \
        float(trees.correlation_ratio(opt, params, grads))


def test_a_leaf_that_did_not_move_gives_nan_as_in_jax():
    opt, params, grads = _trees(3)
    opt["epsilon"] = params["epsilon"].copy()
    got = trees.correlation_ratio_per_param(opt, params, grads)["epsilon"]
    want = jax_trees.correlation_ratio_per_param(*(_unflatten(t) for t in (opt, params, grads)))
    assert np.isnan(float(got)) and np.isnan(float(want["epsilon"]))


@pytest.mark.parametrize("shape", [(5, 3), (8, 8)])
def test_sin_theta_distance_matches_jax(shape):
    rs = np.random.RandomState(shape[0])
    a, b = (np.linalg.qr(rs.randn(*shape))[0].astype(np.float32) for _ in range(2))
    got = trees.sin_theta_distance(torch.as_tensor(a), b)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jax_trees.sin_theta_distance(
        jnp.asarray(a), jnp.asarray(b))), **TOL)


FLAGS = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
         "-ow", "--latent_dim", "6", "--padding_dim", "3", "-dd", "3", "--epsilon", "-1",
         "-tdv", "-lr", "1e-3", "--batch_size", "20", "--n_print", "4", "--n_plot", "8",
         "--track_correlation"]


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return fn()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("track")
    saved = os.environ.get("VAE_TPU_COMPILE_CACHE")
    os.environ["VAE_TPU_COMPILE_CACHE"] = ""  # no persistent XLA cache outside the test dir
    try:
        cfg = jax_parse(["j", *FLAGS, "--num_batches", "12", "--kernels", "xla",
                         "--data_dir", str(root)])
        assert _quiet(lambda: jax_main(cfg)) == 0
    finally:
        if saved is None:
            os.environ.pop("VAE_TPU_COMPILE_CACHE")
        else:
            os.environ["VAE_TPU_COMPILE_CACHE"] = saved
    port = lambda *a: _quiet(lambda: cli([*a, *FLAGS, "--device", "cpu",  # noqa: E731
                                          "--data_dir", str(root)]))
    assert port("p", "--num_batches", "12") == 0
    assert port("part", "--num_batches", "6") == 0
    assert port("resumed", "--num_batches", "12", "--resume", str(root / "part")) == 0
    return root


def test_losses_npz_keys_equal_the_jax_cli(runs):
    port, jax_z = np.load(runs / "p" / "losses.npz"), np.load(runs / "j" / "losses.npz")
    assert port.files == jax_z.files
    assert "Correlation Ratio/Decoder/FC0/kernel" in port.files
    for k in port.files:
        if k.startswith("Correlation Ratio"):
            assert port[k].shape == jax_z[k].shape == (3,), k  # evals at 0, 4, 8
            assert np.all(np.isfinite(port[k])), k


def test_resumed_ratios_equal_the_uninterrupted_run(runs):
    a, b = np.load(runs / "p" / "losses.npz"), np.load(runs / "resumed" / "losses.npz")
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("change,match", [
    (dict(track_correlation=True), "--track_correlation is a solo-run diagnostic"),
    (dict(latent_distribution="logistic"), "supports the gaussian latent distribution"),
])
def test_the_grid_refuses_with_the_jax_message(tmp_path, change, match):
    cfg = dataclasses.replace(parse_arguments(["g", *FLAGS[:-1], "--device", "cpu",
                                               "--data_dir", str(tmp_path)]), **change)
    with pytest.raises(NotImplementedError, match=match):
        GridTrainer(cfg, [2, 3])


def _trainer(tmp_path, dist):
    cfg = parse_arguments(["l", *FLAGS[:-1], "--device", "cpu", "--data_dir", str(tmp_path)])
    assert cfg.latent_distribution == "gaussian"  # the CLI forces it, as the reference's does
    cfg.latent_distribution = dist
    out = make_output_dir(cfg.name, True, cfg, data_dir=cfg.data_dir)
    return _quiet(lambda: Trainer(cfg, get_dataset(cfg.dataset, 2, cfg), out))


def test_logistic_sample_latent(tmp_path):
    t = _trainer(tmp_path, "logistic")
    z = t.sample_latent(5, 4000)
    assert z.shape == (4000, 6) and bool(torch.isfinite(z).all())
    assert torch.equal(z, t.sample_latent(5, 4000))  # counter-keyed
    # the standard logistic's moments: mean 0, variance pi^2 / 3
    assert abs(float(z.mean())) < 0.05 and abs(float(z.var()) - np.pi ** 2 / 3) < 0.15
    assert t.sample_latent(5, 10).shape == (10, 6)
    g = _trainer(tmp_path, "gaussian").sample_latent(5, 10)
    assert g.shape == (10, 6 + 6)  # z1 ⊕ z2


@pytest.mark.parametrize("dist", ["gaussian", "logistic"])
def test_latent_likelihood_matches_jax_scipy(tmp_path, dist):
    x = np.random.RandomState(0).randn(50, 6).astype(np.float32) * 3
    stats = jax_norm if dist == "gaussian" else jax_logistic
    want = float(jnp.mean(jnp.sum(stats.logpdf(jnp.asarray(x)), axis=1), axis=0))
    got = _trainer(tmp_path, dist).latent_likelihood(torch.as_tensor(x))
    np.testing.assert_allclose(float(got), want, **TOL)
