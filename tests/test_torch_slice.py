"""The ported linear-VAE slice end to end on the CPU.

  - the CLI (``vae_training_tpu_torch._scripts.run``) on ``--device cpu
    --kernels torch``: artifacts, console format, losses.npz channels;
  - the slice against the JAX package: the same converted parameters and
    noise through training, eval and export give the same numbers;
  - model.pkl written by either package loads in the other;
  - ``--resume`` reproduces an uninterrupted run bitwise;
  - no silent CPU fallback: ``--device cuda`` / ``--kernels cuda`` raise
    here; ``--mesh dp=2`` in one process raises the JAX package's
    ``make_mesh`` error (it never trains on fewer devices), and ``--arch
    conv`` on a manifold raises the JAX engine's message;
  - the port never imports JAX.
"""

import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_test_helpers import run_xla_steps  # noqa: E402
from vae_training_tpu.data import LinearGaussianDataset as JaxLinearGaussian  # noqa: E402
from vae_training_tpu.kernels.linear_vae import _adam_state  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.ops import elbo_terms as jax_elbo_terms  # noqa: E402
from vae_training_tpu.runio import export as jax_export  # noqa: E402
from vae_training_tpu.train import TrainState as JaxTrainState  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu_torch._scripts.run import cli  # noqa: E402
from vae_training_tpu_torch.config import parse_arguments  # noqa: E402
from vae_training_tpu_torch.data import LinearGaussianDataset  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.runio import export  # noqa: E402
from vae_training_tpu_torch.train import eval_step, sample_z  # noqa: E402
from vae_training_tpu_torch.train.loop import Trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW1 = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "",
        "--layer_sizes", "", "-ow", "--latent_dim", "20", "--padding_dim", "9",
        "-dd", "3", "--epsilon", "-1", "-tdv", "-ds", "2", "-lr", "1e-3",
        "--device", "cpu", "--kernels", "torch", "--n_print", "10",
        "--n_plot", "20"]
NPZ_KEYS = {"VAE Loss", "KL divergence", "mse",
            "Squared Norm of padding dimensions", "Decoder Variance",
            "Encoder Variance", "EigenValues", "Average Log Likelihood",
            "Correlation Ratio"}


def run(name, data_dir, *extra, num_batches=30):
    return cli([name, *ROW1, "--num_batches", str(num_batches),
                "--data_dir", str(data_dir), *extra])


def test_cli_end_to_end(tmp_path, capsys):
    assert run("r", tmp_path) == 0
    out = capsys.readouterr().out
    d = tmp_path / "r"
    for f in ("args.json", "losses.npz", "model.pkl", "ckpt.pt",
              "ckpt_meta.json", "ckpt_aux.pkl", "output_0.png", "output_29.png"):
        assert (d / f).exists(), f
    assert "[kernels] torch: plain PyTorch path (--kernels torch)" in out
    assert re.search(r"^Score for real data: \{'Squared Norm of padding dimensions': ",
                     out, re.M)
    lines = re.findall(r"^Batch \| (\d+) \| VAE Loss \| (-?\d+\.\d{3}) \| KL divergence "
                       r"\| -?\d+\.\d{3} \| mse \| -?\d+\.\d{3} \| Squared Norm of "
                       r"padding dimensions \| \d+\.\d{3}", out, re.M)
    assert [int(b) for b, _ in lines] == [0, 10, 20]
    z = np.load(d / "losses.npz")
    assert set(z.files) == NPZ_KEYS
    assert z["VAE Loss"].shape == (33,) and np.all(np.isfinite(z["VAE Loss"]))
    assert z["Encoder Variance"].shape == (3, 20) and z["Decoder Variance"].shape == (3, 1)
    assert z["EigenValues"].shape == (2, 0)


def test_cli_runs_with_bf16_moments(tmp_path, capsys):
    """--adam_dtype bf16 end to end: the weight matrices' moments are
    bfloat16 in the checkpoint, the rest float32."""
    import json

    from vae_training_tpu_torch.runio import checkpoint as ck

    assert run("b", tmp_path, "--adam_dtype", "bf16") == 0
    out = capsys.readouterr().out
    assert "[kernels] torch: plain PyTorch path (--kernels torch) with bf16 Adam moments" in out
    d = tmp_path / "b"
    assert json.loads((d / "args.json").read_text())["adam_dtype"] == "bf16"
    assert ck.read_checkpoint_meta(str(d))["adam_dtype"] == "bf16"
    state = ck.restore_checkpoint(str(d))
    assert {k: t.dtype for k, t in state.m.items()} == {
        "Encoder.FC0.kernel": torch.bfloat16, "Encoder.FC0.bias": torch.float32,
        "Decoder.FC0.kernel": torch.bfloat16, "Decoder.FC0.bias": torch.float32,
        "epsilon_p": torch.float32, "epsilon": torch.float32}
    assert np.all(np.isfinite(np.load(d / "losses.npz")["VAE Loss"]))


def test_slice_matches_jax(tmp_path):
    """JAX init → the port (convert, train 5 steps, eval, export) agrees with
    the JAX package on the same parameters, noise and eval batch."""
    tdv, B, steps = True, 32, 5
    jds = JaxLinearGaussian.create(2, 3, 3, 9)
    jm = jax_build_vae(data_dim=12, latent_dim=20, encoder_layer_sizes="",
                       decoder_layer_sizes="", epsilon=-1.0, tunable_decoder_var=tdv)
    tx = make_adam(1e-3)
    jstate = JaxTrainState.create(
        params=jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 12)), jnp.zeros((1, 20)),
                       jnp.zeros((1, 12)))["params"],
        tx=tx, model_key=jax.random.PRNGKey(1), data_key=jax.random.PRNGKey(2))
    # port side: converted weights, the JAX dataset's A, the torch-path chunk
    path = tmp_path / "init.pkl"
    jax_export.save_model_pkl(str(path), jstate.params, jstate.opt_state)
    state = export.load_model_pkl(str(path))
    assert state.count == state.step == 0
    ds = LinearGaussianDataset.create(2, 3, 3, 9, A=np.asarray(jds.A))
    model = build_vae(data_dim=12, latent_dim=20, epsilon=-1.0, tunable_decoder_var=tdv)
    rs = np.random.RandomState(4)
    xs = np.zeros((steps, B, 12), np.float32)
    xs[:, :, :3] = rs.randn(steps, B, 3).astype(np.float32) @ np.asarray(jds.A).T
    z1s, z2s = rs.randn(steps, B, 20).astype(np.float32), rs.randn(steps, B, 12).astype(np.float32)
    from vae_training_tpu_torch.train import train_chunk

    state, losses = train_chunk(model, ds, state, steps, batch_size=B, lr=1e-3,
                                noise=tuple(torch.as_tensor(a) for a in (xs, z1s, z2s)))
    jparams, jopt, jlosses = run_xla_steps(jm, tx, jstate, jnp.asarray(xs),
                                           jnp.asarray(z1s), jnp.asarray(z2s))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=2e-4, atol=2e-4)
    # eval on the port's own eval draw, recomputed by the JAX package
    eps = torch.tensor(-0.9)
    stats = eval_step(model, ds, state.params, 11, 12, 3, eps, n=200)
    real = ds.sample(11, 3, 200).numpy()
    z1, z2 = (t.numpy() for t in sample_z(12, 3, 200, 20, 12))
    x_hat, mu, logvar_e, eps_out = jm.apply({"params": jparams}, real, z1, z2)
    loss, dkl, mse = jax_elbo_terms(real, x_hat, mu, logvar_e, eps_out)
    fake = jm.apply({"params": jparams}, z1, z2, jnp.float32(-0.9),
                    method=type(jm).generate)
    ref = {"VAE Loss": loss, "KL divergence": dkl, "mse": mse, "_logvar_e": logvar_e,
           "_epsilon": eps_out, **jds.score(fake)}
    assert list(stats) == list(ref)
    for k in ref:
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(ref[k]), rtol=5e-4,
                                   atol=5e-5, err_msg=k)
    # export: the port's model.pkl restores in the JAX package
    out = tmp_path / "port.pkl"
    export.save_model_pkl(str(out), state)
    params2, opt2 = jax_export.load_model_pkl(str(out), jstate.params, jstate.opt_state)
    np.testing.assert_allclose(np.asarray(params2["Encoder"]["FC0"]["kernel"]),
                               np.asarray(jparams["Encoder"]["FC0"]["kernel"]),
                               rtol=5e-4, atol=5e-5)
    assert int(_adam_state(opt2).count) == steps


def test_model_pkl_round_trips_between_packages(tmp_path):
    assert run("r", tmp_path, num_batches=3) == 0
    port_pkl = tmp_path / "r" / "model.pkl"
    with open(port_pkl, "rb") as f:
        sd = pickle.load(f)
    # port → JAX
    jm = jax_build_vae(data_dim=12, latent_dim=20, encoder_layer_sizes="",
                       decoder_layer_sizes="", epsilon=-1.0, tunable_decoder_var=True)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 12)), jnp.zeros((1, 20)),
                      jnp.zeros((1, 12)))["params"]
    jopt = make_adam(1e-3).init(jparams)
    params, opt = jax_export.load_model_pkl(str(port_pkl), jparams, jopt)
    adam = _adam_state(opt)
    assert int(adam.count) == sd["state"]["step"] == 3
    jsd = jax_export.to_reference_state_dict(params, opt)
    for a, b in zip(jax.tree_util.tree_leaves(jsd), jax.tree_util.tree_leaves(sd)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # JAX → port, through --state_dict
    rs = np.random.RandomState(5)
    moved = jax.tree_util.tree_map(lambda a: a + rs.randn(*a.shape).astype(np.float32), params)
    jax_pkl = tmp_path / "jax.pkl"
    jax_export.save_model_pkl(str(jax_pkl), moved, opt)
    cfg = parse_arguments(["s", *ROW1, "--state_dict", str(jax_pkl)])
    trainer = Trainer(cfg, LinearGaussianDataset.create(2, 3, 3, 9), str(tmp_path))
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(moved)}
    assert set(flat) == set(trainer.state.params)
    for k, v in flat.items():
        np.testing.assert_array_equal(trainer.state.params[k].numpy(), v)
    assert trainer.state.count == 3
    # a checkpoint of another model (no -tdv: no epsilon) is refused
    other = parse_arguments(["o", *[f for f in ROW1 if f != "-tdv"],
                             "--state_dict", str(jax_pkl)])
    with pytest.raises(ValueError, match="do not match"):
        Trainer(other, LinearGaussianDataset.create(2, 3, 3, 9), str(tmp_path))


def test_resume_is_bitwise_equal_to_uninterrupted(tmp_path, capsys):
    assert run("full", tmp_path) == 0
    assert run("part", tmp_path, num_batches=17) == 0
    assert run("resumed", tmp_path, "--resume", str(tmp_path / "part")) == 0
    capsys.readouterr()
    a = np.load(tmp_path / "full" / "losses.npz")
    b = np.load(tmp_path / "resumed" / "losses.npz")
    assert set(a.files) == set(b.files) == NPZ_KEYS
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tmp_path / "full" / "model.pkl", "rb") as f:
        pa = pickle.load(f)
    with open(tmp_path / "resumed" / "model.pkl", "rb") as f:
        pb = pickle.load(f)
    la, lb = jax.tree_util.tree_leaves(pa), jax.tree_util.tree_leaves(pb)
    assert len(la) == len(lb) == 19
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_cpu_kernel_wrapper_runs_the_plain_chunk():
    """On CPU tensors the K1 wrapper runs its plain version: the same losses
    as the torch-path chunk from the same state, and no kernel launch."""
    ds = LinearGaussianDataset.create(2, 3, 3, 9)
    model = build_vae(data_dim=12, latent_dim=20, epsilon=-1.0, tunable_decoder_var=True)
    model.init_parameters(0)
    from vae_training_tpu_torch.train import TrainState, train_chunk

    fresh = lambda: TrainState.create(dict(model.named_parameters()), 7, 8)  # noqa: E731
    launches = k1.run_fused_chunk.launches
    cfg = parse_arguments(["k", *ROW1])
    s1, l1 = k1.make_train_chunk(model, ds, cfg)(fresh(), 4)
    s2, l2 = train_chunk(model, ds, fresh(), 4, batch_size=100, lr=1e-3)
    assert k1.run_fused_chunk.launches == launches
    np.testing.assert_array_equal(l1.numpy(), l2.numpy())
    for k in s1.params:
        np.testing.assert_array_equal(s1.params[k].numpy(), s2.params[k].numpy())
    assert s1.step == s2.step == 4


@pytest.mark.parametrize("extra,exc,match", [
    (["--kernels", "cuda"], RuntimeError, "--kernels cuda requested"),
    (["--device", "cuda"], RuntimeError, "no CUDA device"),
    (["--arch", "conv"], ValueError, "--arch conv requires an image dataset"),
    (["--seed_grid", "2,3", "--kernels", "cuda"], RuntimeError, "--kernels cuda requested"),
    (["--mesh", "dp=2"], ValueError, r"Mesh \{'dp': 2\} needs 2 devices but only 1 available"),
])
def test_no_silent_fallback_and_unported_flags(tmp_path, extra, exc, match):
    if torch.cuda.is_available() and "cuda" in extra:
        pytest.skip("this host has a CUDA device")
    with pytest.raises(exc, match=match):
        run("e", tmp_path, *extra, num_batches=2)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import vae_training_tpu_torch._scripts.run\n"
            "import vae_training_tpu_torch.kernels.linear_vae\n"
            "import vae_training_tpu_torch.kernels.mlp_vae\n"
            "import vae_training_tpu_torch.kernels.dispatch\n"
            "from vae_training_tpu_torch.data import SigmoidDataset, SphereDataset\n"
            "import vae_training_tpu_torch.data.images, vae_training_tpu_torch.models.conv\n"
            "import vae_training_tpu_torch._scripts.bench, vae_training_tpu_torch._scripts.sample\n"
            "import vae_training_tpu_torch.parallel.api, vae_training_tpu_torch.parallel.dp\n"
            "import vae_training_tpu_torch.parallel.gspmd, vae_training_tpu_torch.parallel.mesh\n"
            "import vae_training_tpu_torch.parallel.dryrun, vae_training_tpu_torch.utils.process\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'vae_training_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_checkpoint_retention_and_step_guard(tmp_path):
    from vae_training_tpu_torch.runio import checkpoint as ck
    from vae_training_tpu_torch.train import TrainState

    def state(step):
        return TrainState(params={"w": torch.full((2,), float(step))}, m={"w": torch.zeros(2)},
                          v={"w": torch.zeros(2)}, count=step, step=step,
                          data_seed=2**64 - 1, model_seed=3)

    d = str(tmp_path)
    ck.save_checkpoint(d, state(5), aux={"eval_counter": 1})
    ck.save_checkpoint(d, state(10), extra_meta={"current_epsilon": -0.5},
                       aux={"eval_counter": 2})
    assert ck.read_checkpoint_meta(d) == {"step": 10, "backend": "torch", "adam_dtype": "f32",
                                          "current_epsilon": -0.5}
    assert ck.restore_checkpoint_aux(d) == {"eval_counter": 2, "step": 10}
    with open(os.path.join(d, ck.META_NAME + ck.PREV_SUFFIX)) as f:
        assert '"step": 5' in f.read()
    ck.save_checkpoint(d, state(3))  # older: refused
    restored = ck.restore_checkpoint(d)
    assert restored.step == 10 and restored.data_seed == 2**64 - 1
    assert torch.equal(restored.params["w"], torch.full((2,), 10.0))
    # a kill between the retention set-aside and the install leaves .prev only
    os.remove(os.path.join(d, ck.CKPT_NAME))
    assert ck.checkpoint_exists(d) and ck.restore_checkpoint(d).step == 5


def test_flag_surface_matches_jax():
    """Every flag of the JAX CLI parses here with the same option strings,
    destination and default; only --kernels changes its choices and
    --device is new."""
    from vae_training_tpu.config import build_parser as jax_parser
    from vae_training_tpu_torch.config import build_parser

    def actions(parser):
        return {a.dest: a for a in parser._actions if a.dest != "help"}

    ref, port = actions(jax_parser()), actions(build_parser())
    assert set(port) - set(ref) == {"device"}
    for dest, a in ref.items():
        b = port[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.default == a.default, dest
        if dest != "kernels":
            assert b.choices == a.choices, dest
    assert port["kernels"].choices == ["auto", "torch", "cuda"]
