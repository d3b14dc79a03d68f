"""The port's parallel training paths in four gloo ranks, against the JAX
package's on its 8 host devices and against the port's single device.

Four ranks (``tests/torch_parallel_ranks.py train``, one process group)
run every case once; each test reads its case. Tolerances are
tests/test_pallas_kernel.py's (``TOL``, fp32 on both sides) where a
trajectory is compared, and JAX's own where JAX states one.

  - dp against JAX: ``dp=4`` and ``dp_dcn=2,dp=2``, each rank fed its
    shard's (x, z1, z2) through the noise hook for 20 steps, equal the
    JAX package's ``make_elbo_grad_fn`` + ``pmean`` (over dp, then dp_dcn)
    + optax Adam under a 4-device ``jax.shard_map`` fed the same shards:
    losses, parameters and Adam moments, on every rank;
  - dp against the port's single device: with the port's own streams,
    ``dp=4`` ≡ ``dp_dcn=2,dp=2`` ≡ no mesh on the same global batch; a
    batch that does not divide raises the JAX package's message;
  - tp: ``dp=2,tp=2`` and ``tp=4`` against the single device, 50 steps, at
    JAX's ``rtol=2e-3, atol=2e-4`` (losses) and ``5e-3, 5e-4`` (parameters;
    tests/test_parallel.py:208-214), each rank holding 1/tp of an even
    ``FC`` kernel;
  - the epoch chunk's dp branch: a rank's slice of the permutation is the
    JAX package's index arithmetic (``step.py:245-256``), and two epochs at
    ``dp=4`` on an 8×8×1 conv corpus equal the single-device
    ``EpochChunk``;
  - ``InvertibleBatchNorm`` over a gloo group of four ≡ single-process
    BatchNorm over the whole batch (outputs and running stats at rtol
    1e-5, gradients at rtol 1e-4) and ≡ JAX's ``axis_name="dp"`` module
    under ``shard_map`` (rtol 1e-4, atol 1e-5: tests/test_flow_ops.py:55);
  - ``dryrun_multichip(4)``, the gloo twin of the JAX dry run, passes.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

torch = pytest.importorskip("torch")

from vae_training_tpu.data import LinearGaussianDataset as JaxLinearGaussian  # noqa: E402
from vae_training_tpu.kernels.linear_vae import _adam_state  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.ops.flows import InvertibleBatchNorm as JaxBatchNorm  # noqa: E402
from vae_training_tpu.runio import export as jax_export  # noqa: E402
from vae_training_tpu.train import TrainState as JaxTrainState  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu.train.step import make_elbo_grad_fn  # noqa: E402
from vae_training_tpu_torch.data import ImageDataset, LinearGaussianDataset  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.models.conv import build_conv_vae  # noqa: E402
from vae_training_tpu_torch.ops import rng  # noqa: E402
from vae_training_tpu_torch.ops.flows import InvertibleBatchNorm  # noqa: E402
from vae_training_tpu_torch.parallel.dryrun import spawn_ranks  # noqa: E402
from vae_training_tpu_torch.runio import export  # noqa: E402
from vae_training_tpu_torch.train import TrainState, step as torch_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_parallel_ranks.py")
TOL = {"losses": (2e-4, 2e-4), "params": (5e-4, 5e-5), "m": (5e-4, 1e-6),
       "v": (5e-4, 1e-7)}
MLP = dict(data_dim=5, latent_dim=4, encoder_layer_sizes="16", decoder_layer_sizes="16",
           epsilon=-1.0, tunable_decoder_var=True)
B, STEPS, LR = 32, 20, 1e-3
LINEAR = dict(seed=2, dimension=3, intrinsic_dimension=3, padding_dimension=2)
CONV = dict(latent_dim=4, channels_spec="4|8", epsilon=-1.0, tunable_decoder_var=True)
EPOCH = dict(n=64, size=8, batch=16, lr=1e-3)


def _fresh(model, data=2, z=0):
    return TrainState.create(dict(model.named_parameters()),
                             data_seed=rng.derive_seed(data, rng.SEED_TRAIN_DATA),
                             model_seed=rng.derive_seed(z, rng.SEED_TRAIN_Z))


def _clone(state):
    copy = lambda d: {k: t.clone() for k, t in d.items()}  # noqa: E731
    return TrainState(copy(state.params), copy(state.m), copy(state.v), state.count,
                      state.step, state.data_seed, state.model_seed)


def _jax_state(tmp):
    """A JAX init of the 16|16 MLP, and the same state in the port."""
    jm = jax_build_vae(**MLP)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 5)), jnp.zeros((1, 4)),
                     jnp.zeros((1, 5)))["params"]
    jstate = JaxTrainState.create(params=params, tx=make_adam(LR),
                                  model_key=jax.random.PRNGKey(1),
                                  data_key=jax.random.PRNGKey(2))
    path = os.path.join(tmp, "init.pkl")
    jax_export.save_model_pkl(path, jstate.params, jstate.opt_state)
    return jm, jstate, export.load_model_pkl(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, [every rank's results]) of one four-rank run."""
    tmp = str(tmp_path_factory.mktemp("parallel_training"))
    jm, jstate, state = _jax_state(tmp)
    rs = np.random.RandomState(0)
    noise = tuple(rs.randn(STEPS, B, d).astype(np.float32) for d in (5, 4, 5))
    model = build_vae(**MLP)
    model.init_parameters(0)
    ds = ImageDataset.synthetic_digits(0, n=EPOCH["n"], size=EPOCH["size"])
    conv = build_conv_vae(image_hwc=ds.shape, **CONV)
    conv.init_parameters(0)
    rs = np.random.RandomState(1)
    inputs = {
        "dp_hook": dict(model=MLP, padding=2, batch=B, lr=LR, steps=STEPS, noise=noise,
                        state=state),
        "dp_streams": dict(model=MLP, dataset=LINEAR, batch=B, lr=LR, steps=STEPS,
                           state=_fresh(model)),
        "tp": dict(model=MLP, dataset=LINEAR, batch=B, lr=LR, steps=50,
                   state=_fresh(model)),
        "epoch": dict(EPOCH, model=CONV, state=_fresh(conv, 0)),
        "bn": dict(x=(rs.randn(64, 6) * 3.0 + 2.0).astype(np.float32),
                   w=rs.randn(64, 6).astype(np.float32)),
    }
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    results = spawn_ranks(4, [sys.executable, RANKS, "train", tmp], timeout=120, cwd=REPO,
                          env={"PYTHONPATH": REPO})
    for r, (rc, _, err) in enumerate(results):
        assert rc == 0, f"rank {r} failed:\n{err[-4000:]}"
    got = [torch.load(os.path.join(tmp, f"train_rank{r}.pt"), weights_only=False)
           for r in range(4)]
    return dict(inputs, jax=(jm, jstate)), got


def _close(port, ref, what):
    for name in ("losses", "params", "m", "v"):
        a, b = port[name], ref[name]
        if name == "losses":
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), *TOL[name],
                                       err_msg=f"{what} losses")
            continue
        assert set(a) == set(b), (what, name)
        for k in a:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), *TOL[name],
                                       err_msg=f"{what} {name}[{k}]")


def _replicated(got, case):
    """Every rank holds the same state after a dp chunk (bitwise: the
    all-reduce gives every rank the same sums)."""
    for tree in ("params", "m", "v"):
        for k, t in got[0][case][tree].items():
            for r in range(1, 4):
                assert torch.equal(t, got[r][case][tree][k]), (case, tree, k, r)
    for r in range(1, 4):
        assert torch.equal(got[0][case]["losses"], got[r][case]["losses"]), (case, r)


def _flat_jax(tree):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mesh,shape,names", [
    ("dp=4", (4,), ("dp",)),
    ("dp_dcn=2,dp=2", (2, 2), ("dp_dcn", "dp")),
])
def test_dp_against_jax_shard_map(ranks, mesh, shape, names):
    inputs, got = ranks
    jm, jstate = inputs["jax"]
    grad_fn = make_elbo_grad_fn(jm)
    tx = make_adam(LR)
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), names)

    def local(params, opt, xs, z1s, z2s):
        def body(carry, batch):
            params, opt = carry
            loss, grads = grad_fn(params, *batch)
            grads, loss = jax.lax.pmean((grads, loss), "dp")
            if "dp_dcn" in names:  # hierarchical: dp first, then dp_dcn
                grads, loss = jax.lax.pmean((grads, loss), "dp_dcn")
            updates, opt = tx.update(grads, opt, params)
            return (optax.apply_updates(params, updates), opt), loss
        (params, opt), losses = jax.lax.scan(body, (params, opt), (xs, z1s, z2s))
        return params, opt, losses

    rows = P(None, names if len(names) > 1 else names[0])
    params, opt, losses = jax.jit(jax.shard_map(
        local, mesh=jmesh, in_specs=(P(), P(), rows, rows, rows),
        out_specs=(P(), P(), P()), check_vma=False))(
        jstate.params, jstate.opt_state, *map(jnp.asarray, inputs["dp_hook"]["noise"]))
    adam = _adam_state(opt)
    ref = {"losses": losses, "params": _flat_jax(params), "m": _flat_jax(adam.mu),
           "v": _flat_jax(adam.nu)}
    case = f"hook {mesh}"
    _replicated(got, case)
    _close(got[0][case], ref, case)
    assert got[0][case]["step"] == got[0][case]["count"] == STEPS


def test_dp_against_the_single_device(ranks):
    inputs, got = ranks
    streams = inputs["dp_streams"]
    model = build_vae(**MLP)
    state, losses = torch_step.train_chunk(
        model, LinearGaussianDataset.create(**LINEAR), _clone(streams["state"]), STEPS,
        batch_size=B, lr=LR)
    ref = {"losses": losses, "params": state.params, "m": state.m, "v": state.v}
    for mesh in ("dp=4", "dp_dcn=2,dp=2"):
        _replicated(got, f"streams {mesh}")
        _close(got[0][f"streams {mesh}"], ref, f"streams {mesh}")
    # dp_dcn=2,dp=2 draws what dp=4 draws: only the reduction order differs
    _close(got[0]["streams dp=4"], got[0]["streams dp_dcn=2,dp=2"], "dp=4 vs dp_dcn")
    assert got[0]["indivisible dp=4"] == "--batch_size 30 must be divisible by dp=4"
    assert got[0]["indivisible dp_dcn=2,dp=2"] == \
        "--batch_size 30 must be divisible by dp_dcn*dp=4"


@pytest.mark.parametrize("mesh,tp", [("dp=2,tp=2", 2), ("tp=4", 4)])
def test_tp_against_the_single_device(ranks, mesh, tp):
    inputs, got = ranks
    model = build_vae(**MLP)
    state, losses = torch_step.train_chunk(
        model, LinearGaussianDataset.create(**LINEAR), _clone(inputs["tp"]["state"]), 50,
        batch_size=B, lr=LR)
    case = got[0][f"tp {mesh}"]
    np.testing.assert_allclose(case["losses"].numpy(), losses.numpy(), rtol=2e-3, atol=2e-4)
    for k, t in state.params.items():
        np.testing.assert_allclose(case["params"][k].numpy(), t.numpy(), rtol=5e-3,
                                   atol=5e-4, err_msg=k)
    # really sharded: 1/tp of the column-parallel FC0 kernel (5, 16) a rank
    assert all(g[f"tp {mesh}"]["shard"] == (5, 16 // tp) for g in got)
    for r in range(1, 4):  # the gathered state is whole and the same on every rank
        for k, t in case["params"].items():
            assert torch.equal(t, got[r][f"tp {mesh}"]["params"][k]), (mesh, k, r)


def test_epoch_rank_slices_are_the_jax_index_arithmetic():
    """Rank r of dp takes perm[i·B + r·lb : i·B + (r+1)·lb] of step i, the
    JAX package's ``base = i * batch_size + device_index() * local_bs``
    with ``lax.dynamic_slice`` (step.py:245-256)."""
    n, batch, dp = 64, 16, 4
    lb = batch // dp
    perm = np.random.RandomState(3).permutation(n)
    corpus = torch.arange(n, dtype=torch.float32).view(n, 1)
    batches = torch_step.EpochBatches(corpus, batch)
    batches.set_epoch(torch.as_tensor(perm), 7)
    for i in range(n // batch):
        for r in range(dp):
            want = jax.lax.dynamic_slice(jnp.asarray(perm), (i * batch + r * lb,), (lb,))
            for step in (7 + i, torch.tensor(7 + i)):
                got = batches.sample(0, step, lb, row0=r * lb).view(-1).long().numpy()
                np.testing.assert_array_equal(got, np.asarray(want))


def test_epoch_dp_against_the_single_device(ranks):
    inputs, got = ranks
    ds = ImageDataset.synthetic_digits(0, n=EPOCH["n"], size=EPOCH["size"])
    conv = build_conv_vae(image_hwc=ds.shape, **CONV)
    chunk = torch_step.EpochChunk(conv, ds, batch_size=EPOCH["batch"], lr=EPOCH["lr"],
                                  graph=False)
    state, losses = _clone(inputs["epoch"]["state"]), []
    for epoch in range(2):
        state, ls = chunk(state, epoch)
        losses.append(ls)
    ref = {"losses": torch.cat(losses), "params": state.params, "m": state.m, "v": state.v}
    _replicated(got, "epoch")
    _close(got[0]["epoch"], ref, "epoch dp=4")
    assert got[0]["epoch"]["step"] == 8


def test_batch_norm_over_a_group(ranks):
    inputs, got = ranks
    x = torch.as_tensor(inputs["bn"]["x"]).requires_grad_(True)
    bn = InvertibleBatchNorm(6)
    y = bn(x)
    (y * torch.as_tensor(inputs["bn"]["w"])).sum().backward()
    cat = lambda k: torch.cat([g["bn"][k] for g in got]).numpy()  # noqa: E731
    np.testing.assert_allclose(cat("y"), y.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cat("x_grad"), x.grad.numpy(), rtol=1e-4, atol=1e-6)
    for k in ("scale", "bias"):  # a parameter's gradient: the ranks' sum
        total = sum(g["bn"][f"{k}_grad"] for g in got)
        np.testing.assert_allclose(total.numpy(), getattr(bn, k).grad.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k, b in bn.named_buffers():
        if k == "recent_mean":
            b = b.reshape(-1)
        for g in got:
            np.testing.assert_allclose(g["bn"][k].reshape(-1).numpy(), b.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    # the JAX module with axis_name="dp" under shard_map, on the same batch
    jbn = JaxBatchNorm(axis_name="dp")
    jx = jnp.asarray(inputs["bn"]["x"])
    variables = jbn.init(jax.random.PRNGKey(0), jx[:16])

    def f(xs):
        out, mut = jbn.apply(variables, xs, mutable=["batch_stats"])
        return out, mut["batch_stats"]["recent_mul"]

    jy, jmul = jax.jit(jax.shard_map(
        f, mesh=Mesh(np.array(jax.devices()[:4]), ("dp",)), in_specs=(P("dp"),),
        out_specs=(P("dp"), P("dp")), check_vma=False))(jx)
    np.testing.assert_allclose(cat("y"), np.asarray(jy), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0]["bn"]["recent_mul"].numpy(),
                               np.asarray(jmul).reshape(4, -1)[0], rtol=1e-4, atol=1e-5)


def test_dryrun_multichip_in_four_gloo_ranks():
    out = subprocess.run([sys.executable, "-m", "vae_training_tpu_torch.parallel.dryrun", "4"],
                         capture_output=True, text=True, cwd=REPO, timeout=150,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-4000:]
    assert "dryrun_multichip(4) over gloo: ok" in out.stdout
