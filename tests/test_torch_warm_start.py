"""The port's warm starts (``models/warm_start.py``, ``-ws``) against the
JAX package's ``vae_training_tpu.models.warm_start``, the counterpart of
``tests/test_warm_start.py``:

  - both initializers, given the JAX function's own four draws for the
    same key and the JAX dataset's matrix A, write the JAX leaves (to
    1e-6: both are float32 arithmetic on the same inputs; numpy's and
    XLA's pinv and sums may round differently) and leave the other leaves
    as they were;
  - the same preconditions, with the same messages;
  - without ``draws`` the perturbations are the warm-start Philox streams;
  - ``-ws`` lowers the first eval loss (``test_warm_start_accelerates_training``);
  - the CLI's ``-ws`` on the CPU, on linear and sigmoid rows; ``--seed_grid``
    rows with ``-ws`` equal their solo ``-ws`` runs bitwise;
  - ``-wsl`` parses and changes nothing, as in the JAX CLI.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu.config import parse_arguments as jax_parse  # noqa: E402
from vae_training_tpu.data import LinearGaussianDataset as JaxLinear  # noqa: E402
from vae_training_tpu.data import SigmoidDataset as JaxSigmoid  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.models import warm_start as jax_ws  # noqa: E402
from vae_training_tpu_torch._scripts.run import cli  # noqa: E402
from vae_training_tpu_torch.config import RunConfig  # noqa: E402
from vae_training_tpu_torch.data import LinearGaussianDataset, SigmoidDataset, get_dataset  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.models import warm_start as ws  # noqa: E402
from vae_training_tpu_torch.ops import rng  # noqa: E402
from vae_training_tpu_torch.runio import make_output_dir  # noqa: E402
from vae_training_tpu_torch.train.loop import Trainer  # noqa: E402

KEY = jax.random.PRNGKey(7)
TOL = dict(rtol=1e-6, atol=1e-6)


def _jax_params(model, data_dim, latent_dim):
    return dict(model.init(KEY, jnp.zeros((1, data_dim)), jnp.zeros((1, latent_dim)),
                           jnp.zeros((1, data_dim)))["params"])


def _port_params(data_dim, latent_dim, dataset_name=None):
    model = build_vae(data_dim=data_dim, latent_dim=latent_dim, dataset_name=dataset_name)
    model.init_parameters(0)
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def _jax_draws(key, shapes):
    return [np.asarray(jax.random.normal(k, s)) for k, s in zip(jax.random.split(key, 4), shapes)]


def _leaf(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return np.asarray(tree)


def _hold(port_new, port_old, jax_new, written):
    for name, t in port_new.items():
        if name in written:
            np.testing.assert_allclose(t.numpy(), _leaf(jax_new, name), **TOL, err_msg=name)
        else:
            assert torch.equal(t, port_old[name]), name


@pytest.mark.parametrize("dim,pad", [(3, 2), (4, 0)])
def test_sigmoid_warm_start_matches_jax(dim, pad):
    jds = JaxSigmoid.create(2, dimension=dim, padding_dimension=pad)
    ds = SigmoidDataset.create(2, dim, pad, A=np.asarray(jds.A))
    latent = ds.dimension
    jnew = jax_ws.warm_start_sigmoid(
        _jax_params(jax_build_vae(data_dim=latent, latent_dim=latent, dataset_name="sigmoid"),
                    latent, latent), jds, latent, KEY)
    draws = _jax_draws(KEY, [(latent, latent), (latent, latent), (latent,), (latent, latent)])
    params = _port_params(latent, latent, "sigmoid")
    new = ws.warm_start_sigmoid(params, ds, latent, draws=draws)
    _hold(new, params, jnew, {"Decoder.FC0.kernel", "SigDecoder.FC0.kernel",
                              "Encoder.FC0.kernel", "epsilon_p"})


@pytest.mark.parametrize("dim,pad,latent,off", [(3, 4, 8, 1), (3, 9, 20, 2)])
def test_linear_warm_start_matches_jax(dim, pad, latent, off):
    jds = JaxLinear.create(2, dimension=dim, intrinsic_dimension=dim, padding_dimension=pad)
    ds = LinearGaussianDataset.create(2, dim, dim, pad, A=np.asarray(jds.A))
    D = ds.dimension
    jnew = jax_ws.warm_start_linear_gaussian(
        _jax_params(jax_build_vae(data_dim=D, latent_dim=latent), D, latent), jds, latent,
        off, KEY)
    draws = _jax_draws(KEY, [(dim, off), (D, latent), (latent, D), (latent,)])
    params = _port_params(D, latent)
    new = ws.apply_warm_start(params, "linear_gaussian", ds, latent, off, draws=draws)
    _hold(new, params, jnew, {"Decoder.FC0.kernel", "Encoder.FC0.kernel", "epsilon_p"})


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["sigmoid latent", "linear off", "linear intrinsic"])
def test_preconditions_match_jax(case):
    if case == "sigmoid latent":
        jds = JaxSigmoid.create(2, dimension=3, padding_dimension=2)
        ds = SigmoidDataset.create(2, 3, 2, A=np.asarray(jds.A))
        jp = _jax_params(jax_build_vae(data_dim=6, latent_dim=4, dataset_name="sigmoid"), 6, 4)
        want = _message(lambda: jax_ws.warm_start_sigmoid(jp, jds, 4, KEY))
        got = _message(lambda: ws.warm_start_sigmoid(_port_params(6, 4, "sigmoid"), ds, 4, 1))
    else:
        intrinsic, latent = (3, 4) if case == "linear off" else (2, 8)
        jds = JaxLinear.create(2, dimension=3, intrinsic_dimension=intrinsic, padding_dimension=0)
        ds = LinearGaussianDataset.create(2, 3, intrinsic, 0, A=np.asarray(jds.A))
        jp = _jax_params(jax_build_vae(data_dim=3, latent_dim=latent), 3, latent)
        want = _message(lambda: jax_ws.warm_start_linear_gaussian(jp, jds, latent, 1, KEY))
        got = _message(lambda: ws.warm_start_linear_gaussian(
            _port_params(3, latent), ds, latent, 1, 1))
    assert got == want


def test_perturbations_are_the_warm_start_streams():
    seed = rng.derive_seed(0, rng.SEED_WARM_START)
    assert rng.SEED_WARM_START == rng.SEED_PLOT_Z + 1
    a, b = ws.perturbations(seed, [(3, 5), (4,)])
    np.testing.assert_array_equal(a, rng.normals(seed, 0, 3, rng.STREAM_MANIFOLD, 5).numpy())
    np.testing.assert_array_equal(b, rng.normals(seed, 1, 1, rng.STREAM_MANIFOLD, 4).numpy()[0])
    ds = LinearGaussianDataset.create(2, 3, 3, 4)
    params = _port_params(7, 8)
    drawn = ws.warm_start_linear_gaussian(params, ds, 8, 1, seed)
    given = ws.warm_start_linear_gaussian(params, ds, 8, 1, draws=ws.perturbations(
        seed, [(3, 1), (7, 8), (8, 7), (8,)]))
    for k in drawn:
        assert torch.equal(drawn[k], given[k]), k
    with pytest.raises(ValueError, match="draws must have the shapes"):
        ws.warm_start_linear_gaussian(params, ds, 8, 1, draws=[np.zeros(3)] * 4)


def test_warm_start_accelerates_training(tmp_path):
    """A warm-started linear VAE starts with a far lower eval loss."""
    results = {}
    for warm in (False, True):
        cfg = RunConfig(
            name=f"ws{warm}", dataset="linear_gaussian", encoder_layer_sizes="",
            layer_sizes="", latent_dimension=8, padding_dim=3, dataset_dimension=3,
            num_batches=10, batch_size=50, epsilon=-1.0, tunable_decoder_var=True,
            warm_start=warm, latent_off_dimension=1, dataset_seed=2, overwrite=True,
            tqdm=False, data_dir=str(tmp_path), device="cpu").validate()
        out = make_output_dir(cfg.name, True, cfg, data_dir=cfg.data_dir)
        ds = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
        results[warm] = float(Trainer(cfg, ds, out).compute_stats()["VAE Loss"])
    assert results[True] < results[False]


LINEAR = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
          "-ow", "--latent_dim", "20", "--padding_dim", "9", "-dd", "3", "--epsilon", "-1",
          "-tdv", "-lr", "1e-3"]
SIGMOID = ["--dataset", "sigmoid", "--encoder_layer_sizes", "", "--layer_sizes", "", "-ow",
           "--latent_dim", "7", "--padding_dim", "3", "-dd", "3", "--epsilon", "-3", "-tdv",
           "-lr", "1e-4"]


def _run(tmp_path, name, row, *extra, num_batches=6):
    assert cli([name, *row, "--device", "cpu", "--num_batches", str(num_batches),
                "--n_print", "3", "--n_plot", "3", "--data_dir", str(tmp_path), *extra]) == 0


def _same_run(dir_a, dir_b):
    za, zb = np.load(os.path.join(dir_a, "losses.npz")), np.load(os.path.join(dir_b, "losses.npz"))
    assert za.files == zb.files
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with open(os.path.join(dir_a, "model.pkl"), "rb") as fa, \
            open(os.path.join(dir_b, "model.pkl"), "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("row", ["linear", "sigmoid"])
def test_cli_warm_start_on_the_cpu(tmp_path, row):
    flags = LINEAR if row == "linear" else SIGMOID
    _run(tmp_path, "cold", flags)
    _run(tmp_path, "warm", flags, "-ws")
    cold, warm = (np.load(tmp_path / name / "losses.npz") for name in ("cold", "warm"))
    assert warm["VAE Loss"][0] < cold["VAE Loss"][0]
    assert np.all(np.isfinite(warm["VAE Loss"]))


def test_seed_grid_warm_rows_equal_solo_runs(tmp_path):
    _run(tmp_path, "g", LINEAR, "-ws", "--seed_grid", "2,3")
    for seed in (2, 3):
        _run(tmp_path, f"s{seed}", LINEAR, "-ws", "-ds", str(seed))
        _same_run(tmp_path / f"g_seed{seed}", tmp_path / f"s{seed}")


def test_wsl_is_inert_as_in_the_jax_cli(tmp_path):
    assert jax_parse(["x", "-wsl"]).warm_start_linear is True  # parses there, nothing reads it
    _run(tmp_path, "plain", LINEAR)
    _run(tmp_path, "wsl", LINEAR, "-wsl")
    _same_run(tmp_path / "plain", tmp_path / "wsl")
