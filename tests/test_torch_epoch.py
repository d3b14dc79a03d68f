"""Epoch mode in the port (``train/step.py`` ``EpochChunk``, ``train/loop.py``
``train_epochs``) against the JAX package's, on the CPU.

  - two epochs of three steps through the port's epoch chunk with the
    noise hook ``(perm, z1s, z2s)`` equal a JAX loop built on
    ``make_elbo_grad_fn`` and optax Adam with the same numpy-made
    permutations and noise: losses, parameters and Adam moments, to
    tests/test_pallas_kernel.py's tolerances (fp32 on both sides), for the
    conv VAE and for ``--arch mlp`` on the flat images;
  - the graph form's step (``counter_step_`` on the device counters, the
    gather through ``EpochBatches``' static buffers) run op by op equals the
    op-by-op epoch bitwise; the graph form takes whole epochs and, on the
    CPU, raises rather than run op by op;
  - the CLI, port against the JAX CLI, ``--arch auto`` (conv) and ``mlp``:
    the console's line structure ("Epoch" stat lines, ``Completed Epoch
    k``), the ``losses.npz`` keys and shapes (3 epochs × 8 batches + 4
    evals) and the ``model.pkl`` keys and shapes; a JAX conv run's
    ``model.pkl`` through ``--state_dict`` gives the JAX eval loss on the
    same batch (rtol 1e-5); vae-sample-torch on a JAX conv run equals the
    JAX sampler, and the JAX sampler reads the port's conv run;
  - 2 epochs, then ``--resume`` to 3, equal 3 epochs bitwise;
  - ``--kernels cuda``, ``--seed_grid`` and ``--mesh dp=2`` (in one
    process: the JAX package's ``make_mesh`` error) on an image corpus,
    and ``--arch conv`` on linear_gaussian, raise the JAX package's
    messages;
  - ``vae-bench-torch --config conv --device cpu`` prints its line with the
    JAX bench's ``conv_step_flops``;
  - every entry point sets the card's fp32 math (``use_fp32_math``).
"""

import contextlib
import io
import json
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu._scripts import bench as jax_bench  # noqa: E402
from vae_training_tpu._scripts.run import main as jax_main  # noqa: E402
from vae_training_tpu._scripts.sample import main as jax_sample  # noqa: E402
from vae_training_tpu.config import parse_arguments as jax_parse  # noqa: E402
from vae_training_tpu.data.images import ImageDataset as JaxImageDataset  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.models.conv import build_conv_vae as jax_build_conv  # noqa: E402
from vae_training_tpu.ops import elbo_terms as jax_elbo_terms  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu.train.step import make_elbo_grad_fn  # noqa: E402
from vae_training_tpu_torch import config as port_config  # noqa: E402
from vae_training_tpu_torch._scripts import bench, sample, sweep  # noqa: E402
from vae_training_tpu_torch._scripts import run as port_run  # noqa: E402
from vae_training_tpu_torch.config import parse_arguments  # noqa: E402
from vae_training_tpu_torch.data import ImageDataset, get_dataset  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.models.conv import build_conv_vae  # noqa: E402
from vae_training_tpu_torch.runio.export import load_model_pkl, state_from_flax  # noqa: E402
from vae_training_tpu_torch.train import TrainState  # noqa: E402
from vae_training_tpu_torch.train import step as torch_step  # noqa: E402
from vae_training_tpu_torch.train.loop import Trainer  # noqa: E402

# tests/test_pallas_kernel.py's tolerances (fp32 on both sides)
TOL = {"losses": (2e-4, 2e-4), "params": (5e-4, 5e-5), "m": (5e-4, 1e-6), "v": (5e-4, 1e-7)}
IMAGE = ["--dataset", "image", "--image_size", "16", "--num_images", "256",
         "--batch_size", "32", "--latent_dim", "8", "--conv_channels", "8|16", "-lr", "1e-3",
         "--epsilon", "-1", "-tdv", "-ow"]


def _models(arch, hwc, latent=4):
    d = int(np.prod(hwc))
    if arch == "conv":
        jm = jax_build_conv(image_hwc=hwc, latent_dim=latent, channels_spec="4|8",
                            epsilon=-1.0, tunable_decoder_var=True)
        port = build_conv_vae(image_hwc=hwc, latent_dim=latent, channels_spec="4|8",
                              epsilon=-1.0, tunable_decoder_var=True)
    else:
        jm = jax_build_vae(data_dim=d, latent_dim=latent, encoder_layer_sizes="8",
                           decoder_layer_sizes="8", epsilon=-1.0, tunable_decoder_var=True,
                           dataset_name="image")
        port = build_vae(data_dim=d, latent_dim=latent, encoder_layer_sizes="8",
                         decoder_layer_sizes="8", epsilon=-1.0, tunable_decoder_var=True,
                         dataset_name="image")
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, d)), jnp.zeros((1, latent)),
                     jnp.zeros((1, d)))["params"]
    return jm, port, params


@pytest.mark.parametrize("arch", ["conv", "mlp"])
def test_two_epochs_with_the_hook_equal_a_jax_loop(arch):
    n, size, bs, nb, latent, lr = 12, 8, 4, 3, 4, 1e-3
    jds = JaxImageDataset.synthetic_digits(3, n=n, size=size)
    ds = ImageDataset.synthetic_digits(3, n=n, size=size)
    jm, port, params = _models(arch, ds.shape, latent)
    tx = make_adam(lr)
    opt = tx.init(params)
    zeros = jax.tree_util.tree_map(np.zeros_like, jax.tree_util.tree_map(np.asarray, params))
    state = state_from_flax(jax.tree_util.tree_map(np.asarray, params), zeros, zeros, 0,
                            data_seed=11, model_seed=12)
    chunk = torch_step.EpochChunk(port, ds, batch_size=bs, lr=lr, graph=False)
    grad_fn = jax.jit(make_elbo_grad_fn(jm))
    flat = np.asarray(jds.images).reshape(n, -1)
    rs = np.random.RandomState(5)
    for epoch in range(2):
        perm = rs.permutation(n)
        z1s = rs.randn(nb, bs, latent).astype(np.float32)
        z2s = rs.randn(nb, bs, ds.dimension).astype(np.float32)
        state, losses = chunk(state, epoch, nb, noise=tuple(map(torch.as_tensor,
                                                                (perm, z1s, z2s))))
        jlosses = []
        for i in range(nb):
            batch = flat[perm[i * bs:(i + 1) * bs]]
            loss, grads = grad_fn(params, batch, z1s[i], z2s[i])
            updates, opt = tx.update(grads, opt, params)
            params = optax.apply_updates(params, updates)
            jlosses.append(float(loss))
        np.testing.assert_allclose(losses.numpy(), jlosses, *TOL["losses"])
    assert state.step == state.count == 2 * nb
    adam = opt[0]
    ref = state_from_flax(*(jax.tree_util.tree_map(np.asarray, t)
                            for t in (params, adam.mu, adam.nu)), int(adam.count))
    assert state.count == ref.count
    for tree in ("params", "m", "v"):
        got, want = getattr(state, tree), getattr(ref, tree)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), *TOL[tree],
                                       err_msg=f"{tree}[{k}]")


def test_graph_step_run_op_by_op_equals_the_epoch_chunk():
    """The captured step's gather (a tensor counter into the static
    permutation buffer) against the int-counter epoch, bitwise."""
    ds = ImageDataset.synthetic_digits(4, n=40, size=8)
    model = build_conv_vae(image_hwc=ds.shape, latent_dim=4, channels_spec="4|8",
                           epsilon=-1.0, tunable_decoder_var=True)
    model.init_parameters(0)

    def fresh():
        s = TrainState.create(dict(model.named_parameters()), 21, 22)
        s.step = s.count = 2 * 5  # the third epoch of five steps
        return s

    a = fresh()
    chunk = torch_step.EpochChunk(model, ds, batch_size=8, lr=1e-3, graph=False)
    a, la = chunk(a, 2)
    b = fresh()
    batches = torch_step.EpochBatches(ds.images, 8)
    batches.set_epoch(ds.epoch_permutation(b.data_seed, 2), b.step)
    counters = tuple(torch.tensor(v) for v in (b.step, b.count + 1, 0))
    lb = torch.full((8,), float("nan"))
    with torch_step._requiring_grad(b.params):
        for _ in range(5):
            torch_step.counter_step_(model, batches, b, counters, lb, batch_size=8, lr=1e-3)
    assert torch.equal(la, lb[:5])
    for tree in ("params", "m", "v"):
        for k, t in getattr(a, tree).items():
            assert torch.equal(t, getattr(b, tree)[k]), f"{tree}[{k}]"
    with pytest.raises(ValueError, match="1 to 5 steps"):
        chunk(fresh(), 2, 6)


def test_the_graph_form_takes_whole_epochs_on_the_card_only():
    """One replay holds an epoch: a shorter graph epoch raises, and on the
    CPU the graph form raises instead of running op by op."""
    ds = ImageDataset.synthetic_digits(4, n=40, size=8)
    model = build_conv_vae(image_hwc=ds.shape, latent_dim=4, channels_spec="4|8")
    model.init_parameters(0)
    chunk = torch_step.EpochChunk(model, ds, batch_size=8, lr=1e-3, graph=True)
    state = TrainState.create(dict(model.named_parameters()), 1, 2)
    with pytest.raises(ValueError, match="not a whole number of 5-step graph replays"):
        chunk(state, 0, 2)
    calls = torch_step.train_chunk.calls
    with pytest.raises(ValueError, match="needs a state on a CUDA device"):
        chunk(state, 0)
    assert torch_step.train_chunk.calls == calls


def _captured(fn):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn()
    assert rc == 0, err.getvalue()[-3000:]
    return out.getvalue()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """{arch: {"jax"|"port": (stdout, run dir)}}, 3 epochs each."""
    root = tmp_path_factory.mktemp("epochs")
    saved = os.environ.get("VAE_TPU_COMPILE_CACHE")
    os.environ["VAE_TPU_COMPILE_CACHE"] = ""  # no persistent XLA cache outside the test dir
    try:
        got = {}
        for arch in ("auto", "mlp"):
            flags = [*IMAGE, "--num_epochs", "3", "--arch", arch, "--encoder_layer_sizes",
                     "16", "--layer_sizes", "16", "--data_dir", str(root / arch)]
            cfg = jax_parse(["j", *flags, "--kernels", "xla"])
            got[arch] = {"jax": (_captured(lambda: jax_main(cfg)), root / arch / "j"),
                         "port": (_captured(lambda: port_run.cli(["p", *flags, "--device",
                                                                  "cpu"])),
                                  root / arch / "p")}
        return got
    finally:
        if saved is None:
            os.environ.pop("VAE_TPU_COMPILE_CACHE")
        else:
            os.environ["VAE_TPU_COMPILE_CACHE"] = saved


def _structure(out):
    """The epoch lines in order: ("Epoch", k, stat keys) and ("Completed", k)."""
    lines = []
    for ln in out.splitlines():
        m = re.match(r"^Epoch \| (\d+) \| (.*)$", ln)
        if m:
            lines.append(("Epoch", int(m.group(1)), m.group(2).split(" | ")[::2]))
        m = re.match(r"^Completed Epoch (\d+)$", ln)
        if m:
            lines.append(("Completed", int(m.group(1))))
    return lines


def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    return np.asarray(tree).shape


@pytest.mark.parametrize("arch", ["auto", "mlp"])
def test_cli_matches_the_jax_cli(cli_runs, arch):
    (jout, jdir), (pout, pdir) = cli_runs[arch]["jax"], cli_runs[arch]["port"]
    structure = _structure(jout)
    keys = ["VAE Loss", "KL divergence", "mse"]
    assert structure == [("Epoch", 0, keys)] + [
        line for k in range(3) for line in (("Completed", k), ("Epoch", k, keys))]
    assert _structure(pout) == structure
    (kernels,) = [ln for ln in pout.splitlines() if ln.startswith("[kernels]")]
    assert kernels == ("[kernels] torch: plain PyTorch path (an image corpus in epoch mode: "
                       "the fused kernels train the manifolds); eager (the CPU has no CUDA "
                       "graphs), one epoch a chunk")
    jz, pz = np.load(jdir / "losses.npz"), np.load(pdir / "losses.npz")
    assert pz.files == jz.files
    for k in jz.files:
        assert pz[k].shape == jz[k].shape, k
    assert pz["VAE Loss"].shape == (3 * 8 + 4,) and np.all(np.isfinite(pz["VAE Loss"]))
    with open(jdir / "model.pkl", "rb") as f:
        jpkl = pickle.load(f)
    with open(pdir / "model.pkl", "rb") as f:
        ppkl = pickle.load(f)
    assert _tree_shapes(ppkl) == _tree_shapes(jpkl)
    assert ppkl["state"]["step"] == jpkl["state"]["step"] == 24
    for d in (jdir, pdir):
        assert {"args.json", "output_0.png", "output_2.png"} <= set(os.listdir(d))
    # the JAX CLI's artifact set, the corpus copy included; the checkpoint's
    # files are each package's own format (ckpt.msgpack; ckpt.pt + meta + aux)
    artifacts = lambda d: {f for f in os.listdir(d) if not f.startswith("ckpt")}  # noqa: E731
    assert artifacts(pdir) == artifacts(jdir) and "dataset.pk.npz" in artifacts(pdir)
    pc, jc = np.load(pdir / "dataset.pk.npz"), np.load(jdir / "dataset.pk.npz")
    assert set(pc.files) == set(jc.files)
    for k in jc.files:
        np.testing.assert_array_equal(pc[k], jc[k], err_msg=k)


def test_data_fn_restores_the_saved_corpus_bitwise(cli_runs, tmp_path):
    """--data_fn <run>/dataset.pk loads the corpus a port run saved, bitwise,
    and a run fed it saves the same corpus again."""
    pdir = cli_runs["auto"]["port"][1]
    saved = np.load(pdir / "dataset.pk.npz")["images"]
    flags = ["r", *IMAGE, "--num_epochs", "1", "--device", "cpu", "--data_fn",
             str(pdir / "dataset.pk"), "--data_dir", str(tmp_path)]
    cfg = parse_arguments(flags).validate()
    loaded = get_dataset("image", 0, cfg).load(cfg.data_fn)
    assert loaded.images.dtype == torch.float32
    np.testing.assert_array_equal(loaded.images.numpy(), saved)
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_run.cli(flags) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "r" / "dataset.pk.npz")["images"], saved)


def test_a_jax_conv_model_pkl_gives_the_jax_eval_loss(cli_runs, tmp_path):
    jdir = cli_runs["auto"]["jax"][1]
    cfg = parse_arguments(["s", *IMAGE, "--num_epochs", "1", "--device", "cpu",
                           "--state_dict", str(jdir / "model.pkl")]).validate()
    trainer = Trainer(cfg, get_dataset("image", 0, cfg), str(tmp_path))
    x = trainer.dataset.sample(7, 1, 50)
    z1, z2 = torch_step.sample_z(8, 1, 50, 8, trainer.dataset.dimension)
    got = torch_step.loss_terms(trainer.model, trainer.state.params, x, z1, z2)
    with open(jdir / "model.pkl", "rb") as f:
        target = pickle.load(f)["target"]
    jm = jax_build_conv(image_hwc=(16, 16, 1), latent_dim=8, channels_spec="8|16",
                        epsilon=-1.0, tunable_decoder_var=True)
    x, z1, z2 = (t.numpy() for t in (x, z1, z2))
    out = jm.apply({"params": target}, x, z1, z2)
    want = jax_elbo_terms(x, *out)
    for a, b in zip(got[:3], want):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5)
    assert trainer.state.count == 24


def test_sampling_across_packages(cli_runs, tmp_path):
    """vae-sample-torch on a JAX conv run equals the JAX sampler fed the
    same latents (rtol 1e-5 / atol 1e-5); the port's conv run samples with
    both samplers (the JAX one reads its model.pkl)."""
    jdir, pdir = cli_runs["auto"]["jax"][1], cli_runs["auto"]["port"][1]
    out = tmp_path / "jax.npz"
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_sample([str(jdir), "-n", "64", "-o", str(out), "--seed", "3"]) == 0
    ref = np.load(out)
    trainer = sample.load_run(str(jdir), device="cpu")
    got, _ = trainer.sample_batch(0, 64, latents=ref["latents"])
    np.testing.assert_allclose(got.numpy(), ref["samples"], rtol=1e-5, atol=1e-5)
    for name, fn, extra in (("port", sample.main, ["--device", "cpu"]), ("jax", jax_sample, [])):
        path = tmp_path / f"{name}_of_port.npz"
        with contextlib.redirect_stdout(io.StringIO()):
            assert fn([str(pdir), "-n", "64", "-o", str(path), *extra]) == 0
        z = np.load(path)
        assert z["samples"].shape == (64, 256) and z["latents"].shape == (64, 264), name
        assert np.all(np.isfinite(z["samples"])), name


def test_resume_is_bitwise_equal_to_uninterrupted(tmp_path):
    flags = [*IMAGE, "--device", "cpu", "--data_dir", str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        assert port_run.cli(["full", *flags, "--num_epochs", "3"]) == 0
        assert port_run.cli(["part", *flags, "--num_epochs", "2"]) == 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert port_run.cli(["resumed", *flags, "--num_epochs", "3", "--resume",
                                 str(tmp_path / "part")]) == 0
    assert _structure(out.getvalue()) == [("Completed", 2),
                                          ("Epoch", 2, ["VAE Loss", "KL divergence", "mse"])]
    za, zb = np.load(tmp_path / "full" / "losses.npz"), np.load(tmp_path / "resumed" / "losses.npz")
    assert za.files == zb.files
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    a, b = load_model_pkl(str(tmp_path / "full" / "model.pkl")), \
        load_model_pkl(str(tmp_path / "resumed" / "model.pkl"))
    for tree in ("params", "m", "v"):
        for k, t in getattr(a, tree).items():
            assert torch.equal(t, getattr(b, tree)[k]), f"{tree}[{k}]"
    with open(tmp_path / "resumed" / "ckpt_aux.pkl", "rb") as f:
        assert pickle.load(f)["epoch_num"] == 2


@pytest.mark.parametrize("extra,exc,match", [
    ([*IMAGE, "--kernels", "cuda"], RuntimeError,
     r"--kernels cuda requested but no fused kernel can run: linear kernel: .*; MLP kernel: "),
    ([*IMAGE, "--seed_grid", "2,3"], NotImplementedError, "epoch-mode image corpora"),
    ([*IMAGE, "--mesh", "dp=2"], ValueError,
     r"Mesh \{'dp': 2\} needs 2 devices but only 1 available"),
    (["--dataset", "linear_gaussian", "--arch", "conv"], ValueError,
     r"--arch conv requires an image dataset \(H, W, C\); --dataset linear_gaussian has "
     r"shape \(3,\)"),
    (["--dataset", "linear_gaussian", "--arch", "conv", "--seed_grid", "2,3"], ValueError,
     "--seed_grid supports the MLP VAE architectures"),
])
def test_refusals(tmp_path, extra, exc, match):
    with pytest.raises(exc, match=match):
        port_run.cli(["e", *extra, "--num_epochs", "1", "--num_batches", "2", "-ow",
                      "--device", "cpu", "--data_dir", str(tmp_path)])


def test_bench_conv_on_the_cpu(capsys, monkeypatch):
    calls = []

    def short(call, steps_per_call, device, n_windows=5, min_seconds=1.0):
        calls.append(steps_per_call)
        return windows(call, steps_per_call, device, 2, 0.0)

    windows = bench.windows
    monkeypatch.setattr(bench, "windows", short)
    assert bench.main(["--config", "conv", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    got = json.loads(out)
    assert got["metric"] == "conv_vae_train_steps_per_sec_on_cpu" and got["value"] > 0
    assert got["flops_per_step"] == jax_bench.conv_step_flops(128, (28, 28, 1), 16, (32, 64))
    assert got["mfu_pct"] is None and got["device"] == "cpu"
    assert calls == [32]  # whole epochs: 4096 images // batch 128
    assert "one epoch a chunk" in err and "(32-step chunks" in err


class _Called(Exception):
    pass


@pytest.mark.parametrize("entry", ["run", "sweep", "bench", "sample"])
def test_every_entry_point_sets_the_fp32_math(monkeypatch, tmp_path, entry):
    seen = []

    def record(device):
        seen.append(str(device))
        raise _Called

    module = {"run": port_run, "sweep": sweep, "bench": bench, "sample": sample}[entry]
    monkeypatch.setattr(module, "use_fp32_math", record)
    call = {"run": lambda: port_run.cli(["e", *IMAGE, "--device", "cpu", "--data_dir",
                                         str(tmp_path)]),
            "sweep": lambda: sweep.main(["linear", "--device", "cpu"]),
            "bench": lambda: bench.main(["--device", "cpu"]),
            "sample": lambda: sample.main([str(tmp_path), "--device", "cpu"])}[entry]
    with pytest.raises(_Called):
        call()
    assert seen == ["cpu"]


def test_use_fp32_math_sets_the_cards_flags_only():
    flags = (torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cudnn, "deterministic"), (torch.backends.cudnn, "benchmark")
    saved = [getattr(o, a) for o, a in flags]
    try:
        for (o, a), v in zip(flags, (True, True, False, True)):
            setattr(o, a, v)
        port_config.use_fp32_math("cpu")
        assert [getattr(o, a) for o, a in flags] == [True, True, False, True]
        port_config.use_fp32_math("cuda")
        assert [getattr(o, a) for o, a in flags] == [False, False, True, False]
    finally:
        for (o, a), v in zip(flags, saved):
            setattr(o, a, v)
