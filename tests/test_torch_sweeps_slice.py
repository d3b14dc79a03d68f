"""The sigmoid and sphere sweeps' first rows, end to end on the CPU.

  - the ``sigmoid`` and ``sphere`` datasets against the JAX package's: the
    samples (given the same A and the same normals) and ``score`` on the
    same batch, the sigmoid metric's published quirks included;
  - sigmoid row 1 (pure-linear dual decoder, D 7, L 6) and sphere row 1
    (200|200|200 ReLU stacks, D 6, L 6) at full width through the port's
    torch path against the JAX package's XLA path: the same converted
    parameters and numpy-drawn noise, a few steps, then the eval and the
    score, at ``tests/test_mlp_kernel.py``'s tolerances (losses 3e-4;
    params rtol 1e-3 / atol 1e-5; m 1e-3 / 1e-6; v 1e-3 / 1e-9: fp32 on
    both sides, 200-term sums in other orders);
  - the CLI on ``--device cpu`` for both rows: artifacts and console keys;
  - ``model.pkl`` written by either package loads in the other, for the MLP
    and the SigDecoder trees;
  - ``--resume`` on the sphere row reproduces an uninterrupted run bitwise.
"""

import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_test_helpers import run_xla_steps  # noqa: E402
from vae_training_tpu.data import SigmoidDataset as JaxSigmoid  # noqa: E402
from vae_training_tpu.data import SphereDataset as JaxSphere  # noqa: E402
from vae_training_tpu.kernels.linear_vae import _adam_state  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.ops import elbo_terms as jax_elbo_terms  # noqa: E402
from vae_training_tpu.runio import export as jax_export  # noqa: E402
from vae_training_tpu.train import TrainState as JaxTrainState  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu_torch._scripts.run import cli  # noqa: E402
from vae_training_tpu_torch.config import parse_arguments  # noqa: E402
from vae_training_tpu_torch.data import SigmoidDataset, SphereDataset, get_dataset  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.ops import rng  # noqa: E402
from vae_training_tpu_torch.runio.export import state_from_flax  # noqa: E402
from vae_training_tpu_torch.train import eval_step, sample_z, train_chunk  # noqa: E402
from vae_training_tpu_torch.train.loop import Trainer  # noqa: E402

# bench.py CONFIGS["sigmoid"] / ["sphere"], default seed 69, on the CPU
ROWS = {
    "sigmoid": ["--dataset", "sigmoid", "--encoder_layer_sizes", "", "--layer_sizes", "",
                "-ow", "--latent_dim", "6", "--padding_dim", "3", "-dd", "3",
                "--epsilon", "-3", "-tdv", "-lr", "1e-4"],
    "sphere": ["--dataset", "sphere", "--encoder_layer_sizes", "200|200|200",
               "--layer_sizes", "200|200|200", "-ow", "--latent_dim", "6",
               "--padding_dim", "3", "-dd", "3", "--epsilon", "-3", "-tdv", "-lr", "1e-4"],
}
CPU = ["--device", "cpu", "--n_print", "10", "--n_plot", "20"]
# the engine's order (the JAX engine's jitted eval returns the scores with
# sorted keys): console columns, losses.npz and the banner
SCORE_KEYS = {"sigmoid": ["Squared Norm of Manifold Dimension",
                          "Squared Norm of Padding Dimensions"],
              "sphere": ["Padding Error", "Sphere Error"]}
D = {"sigmoid": 7, "sphere": 6}
HIDDEN = {"sigmoid": "", "sphere": "200|200|200"}
LATENT, B, STEPS = 6, 100, 3
TOL = dict(loss=(3e-4, 3e-4), params=(1e-3, 1e-5), mu=(1e-3, 1e-6), nu=(1e-3, 1e-9))


def run(row, name, data_dir, *extra, num_batches=30):
    return cli([name, *ROWS[row], *CPU, "--num_batches", str(num_batches),
                "--data_dir", str(data_dir), *extra])


def flat(tree):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_row(row):
    if row == "sigmoid":
        dataset = JaxSigmoid.create(69, dimension=3, padding_dimension=3)
    else:
        dataset = JaxSphere(dim=3, padding_dim=3)
    model = jax_build_vae(data_dim=D[row], latent_dim=LATENT,
                          encoder_layer_sizes=HIDDEN[row], decoder_layer_sizes=HIDDEN[row],
                          epsilon=-3.0, tunable_decoder_var=True,
                          dataset_name="sigmoid" if row == "sigmoid" else None)
    tx = make_adam(1e-4)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, D[row])),
                        jnp.zeros((1, LATENT)), jnp.zeros((1, D[row])))["params"]
    state = JaxTrainState.create(params=params, tx=tx, model_key=jax.random.PRNGKey(1),
                                 data_key=jax.random.PRNGKey(2))
    return dataset, model, tx, state


def port_dataset(row, jds):
    if row == "sigmoid":
        return SigmoidDataset.create(69, 3, 3, A=np.asarray(jds.A))
    return SphereDataset(3, 3)


def test_sigmoid_dataset_matches_jax():
    jds = JaxSigmoid.create(69, dimension=3, padding_dimension=3)
    ds = SigmoidDataset.create(69, 3, 3, A=np.asarray(jds.A))
    assert (ds.ndim, ds.dimension, ds.intrinsic_dim) == (jds.ndim, 7, 3)
    # samples: the JAX formula on the port's own normals
    x = ds.sample(11, 5, 64).numpy()
    z = rng.normals(11, 5, 64, rng.STREAM_MANIFOLD, 3).numpy()
    ref = np.concatenate([z, np.asarray(jax.nn.sigmoid(jnp.dot(z, jds.A))),
                          np.zeros((64, 3), np.float32)], axis=1)
    np.testing.assert_allclose(x, ref, rtol=1e-6, atol=1e-6)
    # score: same keys (capitalised as published), same values, quirks kept
    batch = np.random.RandomState(0).randn(256, 7).astype(np.float32)
    got, want = ds.score(torch.as_tensor(batch)), jds.score(jnp.asarray(batch))
    assert list(got) == list(want) == ["Squared Norm of Padding Dimensions",
                                       "Squared Norm of Manifold Dimension"]
    assert sorted(got) == SCORE_KEYS["sigmoid"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)
    # quirk: a perfect sample still scores the σ-coordinate against the
    # logit over all n² cross pairs, so its manifold error is not zero
    perfect = ds.score(ds.sample(3, 0, 512))
    assert perfect["Squared Norm of Padding Dimensions"].item() == 0.0
    assert perfect["Squared Norm of Manifold Dimension"].item() > 0.1
    # the (n, n) broadcast computed literally agrees with the closed form
    c_hat, c = batch[:, 3], batch[:, :3] @ np.asarray(jds.A)
    np.testing.assert_allclose(got["Squared Norm of Manifold Dimension"].numpy(),
                               np.mean(np.square(c_hat - c)), rtol=1e-4)


def test_sphere_dataset_matches_jax():
    jds, ds = JaxSphere(dim=3, padding_dim=3), SphereDataset(3, 3)
    assert (ds.ndim, ds.intrinsic_dim) == (jds.ndim, 3)
    x = ds.sample(11, 5, 64).numpy()
    g = rng.normals(11, 5, 64, rng.STREAM_MANIFOLD, 3).numpy()
    ref = np.concatenate([np.asarray(g / jnp.linalg.norm(g, axis=1, keepdims=True)),
                          np.zeros((64, 3), np.float32)], axis=1)
    np.testing.assert_allclose(x, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(x, axis=1), 1.0, rtol=1e-6)
    batch = np.random.RandomState(1).randn(256, 6).astype(np.float32)
    got, want = ds.score(torch.as_tensor(batch)), jds.score(jnp.asarray(batch))
    assert list(got) == list(want) == ["Sphere Error", "Padding Error"]
    assert sorted(got) == SCORE_KEYS["sphere"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)


def _row_noise(row, jds):
    rs = np.random.RandomState(4)
    g = rs.randn(STEPS, B, 3).astype(np.float32)
    if row == "sigmoid":
        sig = 1 / (1 + np.exp(-(g @ np.asarray(jds.A))))
        xs = np.concatenate([g, sig, np.zeros((STEPS, B, 3), np.float32)], axis=-1)
    else:
        xs = np.concatenate([g / np.linalg.norm(g, axis=-1, keepdims=True),
                             np.zeros((STEPS, B, 3), np.float32)], axis=-1)
    z1s = rs.randn(STEPS, B, LATENT).astype(np.float32)
    z2s = rs.randn(STEPS, B, D[row]).astype(np.float32)
    return xs.astype(np.float32), z1s, z2s


@pytest.mark.parametrize("row", ["sigmoid", "sphere"])
def test_row_matches_jax_xla_at_full_width(row):
    """JAX init → the port's torch path (convert, train, eval, score) agrees
    with the JAX package's XLA path at the row's full width."""
    jds, jm, tx, jstate = jax_row(row)
    adam = _adam_state(jstate.opt_state)
    state = state_from_flax(jax.device_get(jstate.params), jax.device_get(adam.mu),
                            jax.device_get(adam.nu), 0)
    ds = port_dataset(row, jds)
    model = build_vae(data_dim=D[row], latent_dim=LATENT, encoder_layer_sizes=HIDDEN[row],
                      decoder_layer_sizes=HIDDEN[row], epsilon=-3.0,
                      tunable_decoder_var=True,
                      dataset_name="sigmoid" if row == "sigmoid" else None)
    assert set(dict(model.named_parameters())) == set(state.params)
    xs, z1s, z2s = _row_noise(row, jds)
    state, losses = train_chunk(model, ds, state, STEPS, batch_size=B, lr=1e-4,
                                noise=tuple(torch.as_tensor(a) for a in (xs, z1s, z2s)))
    jparams, jopt, jlosses = run_xla_steps(jm, tx, jstate, jnp.asarray(xs),
                                           jnp.asarray(z1s), jnp.asarray(z2s))
    np.testing.assert_allclose(losses.numpy(), jlosses, *TOL["loss"])
    jadam = _adam_state(jopt)
    for got, ref, tol in ((state.params, jparams, "params"), (state.m, jadam.mu, "mu"),
                          (state.v, jadam.nu, "nu")):
        ref = flat(ref)
        assert set(got) == set(ref)
        for name, val in got.items():
            np.testing.assert_allclose(val.numpy(), ref[name], *TOL[tol],
                                       err_msg=f"{tol} {name}")
    # eval on the port's own draws, recomputed by the JAX package
    eps = torch.tensor(-2.9)
    stats = eval_step(model, ds, state.params, 11, 12, 3, eps, n=200)
    real = ds.sample(11, 3, 200).numpy()
    z1, z2 = (t.numpy() for t in sample_z(12, 3, 200, LATENT, D[row]))
    x_hat, mu, logvar_e, eps_out = jm.apply({"params": jparams}, real, z1, z2)
    loss, dkl, mse = jax_elbo_terms(real, x_hat, mu, logvar_e, eps_out)
    fake = jm.apply({"params": jparams}, z1, z2, jnp.float32(-2.9), method=type(jm).generate)
    # the scores as the JAX engine's jitted eval returns them: sorted keys
    ref = {"VAE Loss": loss, "KL divergence": dkl, "mse": mse, "_logvar_e": logvar_e,
           "_epsilon": eps_out, **jax.jit(jds.score)(fake)}
    assert list(stats) == list(ref)
    for k in ref:
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(ref[k]), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("row", ["sigmoid", "sphere"])
def test_cli_end_to_end(row, tmp_path, capsys):
    assert run(row, "r", tmp_path) == 0
    out = capsys.readouterr().out
    d = tmp_path / "r"
    for f in ("args.json", "losses.npz", "model.pkl", "ckpt.pt", "ckpt_meta.json",
              "ckpt_aux.pkl"):
        assert (d / f).exists(), f
    assert "[kernels] torch: plain PyTorch path (device 'cpu' is not a CUDA device)" in out
    keys = SCORE_KEYS[row]
    assert re.search(rf"^Score for real data: \{{'{keys[0]}': .*'{keys[1]}': ", out, re.M)
    lines = re.findall(rf"^Batch \| (\d+) \| VAE Loss \| (-?\d+\.\d{{3}}) \| KL divergence "
                       rf"\| -?\d+\.\d{{3}} \| mse \| -?\d+\.\d{{3}} \| {keys[0]} \| "
                       rf"\d+\.\d{{3}} \| {keys[1]} \| \d+\.\d{{3}}", out, re.M)
    assert [int(b) for b, _ in lines] == [0, 10, 20]
    z = np.load(d / "losses.npz")
    assert set(z.files) == {"VAE Loss", "KL divergence", "mse", *keys, "Decoder Variance",
                            "Encoder Variance", "EigenValues", "Average Log Likelihood",
                            "Correlation Ratio"}
    assert z["VAE Loss"].shape == (33,) and np.all(np.isfinite(z["VAE Loss"]))
    assert z["Encoder Variance"].shape == (3, LATENT)


@pytest.mark.parametrize("row", ["sigmoid", "sphere"])
def test_model_pkl_round_trips_between_packages(row, tmp_path):
    assert run(row, "r", tmp_path, num_batches=3) == 0
    with open(tmp_path / "r" / "model.pkl", "rb") as f:
        sd = pickle.load(f)
    tree = sd["target"]
    assert ("SigDecoder" in tree) == (row == "sigmoid")
    assert set(tree["Decoder"]) == ({"FC0"} if row == "sigmoid" else {"FC0", "FC1", "FC2", "FC3"})
    # port → JAX
    _, jm, tx, jstate = jax_row(row)
    params, opt = jax_export.load_model_pkl(str(tmp_path / "r" / "model.pkl"),
                                            jstate.params, jstate.opt_state)
    assert int(_adam_state(opt).count) == sd["state"]["step"] == 3
    jsd = jax_export.to_reference_state_dict(params, opt)
    la, lb = jax.tree_util.tree_leaves(jsd), jax.tree_util.tree_leaves(sd)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # JAX → port, through --state_dict
    rs = np.random.RandomState(5)
    moved = jax.tree_util.tree_map(lambda a: a + rs.randn(*a.shape).astype(np.float32), params)
    jax_pkl = tmp_path / "jax.pkl"
    jax_export.save_model_pkl(str(jax_pkl), moved, opt)
    cfg = parse_arguments(["s", *ROWS[row], *CPU, "--state_dict", str(jax_pkl)])
    trainer = Trainer(cfg, get_dataset(cfg.dataset, cfg.dataset_seed, cfg), str(tmp_path))
    ref = flat(moved)
    assert set(ref) == set(trainer.state.params)
    for k, v in ref.items():
        np.testing.assert_array_equal(trainer.state.params[k].numpy(), v)
    assert trainer.state.count == 3


def test_sphere_resume_is_bitwise_equal_to_uninterrupted(tmp_path, capsys):
    assert run("sphere", "full", tmp_path) == 0
    assert run("sphere", "part", tmp_path, num_batches=17) == 0
    assert run("sphere", "resumed", tmp_path, "--resume", str(tmp_path / "part")) == 0
    capsys.readouterr()
    a = np.load(tmp_path / "full" / "losses.npz")
    b = np.load(tmp_path / "resumed" / "losses.npz")
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tmp_path / "full" / "model.pkl", "rb") as f:
        pa = pickle.load(f)
    with open(tmp_path / "resumed" / "model.pkl", "rb") as f:
        pb = pickle.load(f)
    la, lb = jax.tree_util.tree_leaves(pa), jax.tree_util.tree_leaves(pb)
    assert len(la) == len(lb) == 3 * 18 + 1  # 16 Dense tensors, epsilon_p, epsilon; ×(p, m, v); step
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
