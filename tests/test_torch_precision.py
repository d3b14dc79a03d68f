"""``--precision bf16`` (bfloat16 dot operands, f32 sums) on the CPU.

On the CPU the JAX package computes f32 dots exactly under every precision
setting, so its own model cannot show the bf16 mode here. The reference for
the mode is the JAX package's own VAE run under ``flax.linen.intercept_methods``
with every ``nn.Dense`` (and, for the conv VAE, ``nn.Conv`` and
``nn.ConvTranspose``) replaced by a ``jax.custom_vjp`` product whose forward
takes bfloat16-cast operands with an f32 result
(``jnp.dot(a.astype(bf16), b.astype(bf16), preferred_element_type=f32)``)
and whose backward rounds the cotangent and both saved operands the same
way: the TPU's default f32 dot in both directions (JAX_bf16). The port
reaches the mode by passing ``bf16_dots=True`` itself; its entry points
resolve ``--precision`` to bf16 dots only on a CUDA device
(``config.bf16_dots``), as XLA's CPU backend computes fp32 under both values.

The measure is ρ = ‖port − JAX_bf16‖ / ‖JAX_fp32 − JAX_bf16‖ over a
quantity's values: the port in bf16 mode must give ρ ≤ 1e-3 and the port's
fp32 path ρ ≥ 0.5 (the negative control that the check tells the modes
apart).

  - the bf16 dot helper (``ops/precision.py``): the forward and both
    gradients against JAX's cast dot (rtol 1e-6) and against float64 sums of
    the rounded operands, at an odd K and at zero-size edges;
  - the manual re-implementation of flax's layers used by JAX_bf16 equals
    flax's own in fp32, so the reference differs from JAX's model only in
    the rounding;
  - one training step from a mid-run Adam state (three JAX fp32 steps on
    other batches): gradients and Adam's new m and v at ρ ≤ 1e-3; the new
    parameters at ρ ≤ 0.1 (one step moves them by about their own f32
    rounding, which floors their ρ); the loss, one scalar, at rtol 1e-6 of
    JAX_bf16's (its f32 summation floor); the fp32 control at ρ ≥ 0.5 on
    all five; at linear row 1, the sigmoid dual decoder (D 7, L
    6), a 16|16|16 MLP (D 6, L 6) on sphere and on linear_gaussian data, and
    the conv VAE at 8|16 channels on 8×8 images;
  - the plain kernel versions under ``bf16_dots=True`` (K1, K2, K5, and
    K6a's and K6b's rows) equal the torch path with the same flag bitwise,
    4 steps of external noise;
  - the samplers' and the sigmoid score's manifold dots against JAX's cast
    dots on the same normals and batches;
  - ``--precision bf16 --device cpu`` computes what ``fp32`` computes,
    bitwise, through the CLI; the resolver; the ``[kernels]`` line; grid
    rows that differ only in ``--precision`` are refused one launch;
  - ``--mesh tp=2`` over gloo in bf16 mode against the unsharded bf16 step
    (tests/test_torch_parallel_training.py's tp tolerances).
"""

import contextlib
import os
import sys
import textwrap

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu.data import SigmoidDataset as JaxSigmoid  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.models.conv import build_conv_vae as jax_build_conv  # noqa: E402
from vae_training_tpu.ops import elbo_terms as jax_elbo_terms  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu_torch.config import RunConfig, bf16_dots  # noqa: E402
from vae_training_tpu_torch.data import (  # noqa: E402
    LinearGaussianDataset,
    SigmoidDataset,
    SphereDataset,
)
from vae_training_tpu_torch.kernels import dispatch  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.kernels import mlp_vae as k5  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.models.conv import build_conv_vae  # noqa: E402
from vae_training_tpu_torch.ops import precision, rng  # noqa: E402
from vae_training_tpu_torch.parallel.dryrun import spawn_ranks  # noqa: E402
from vae_training_tpu_torch.runio.export import state_from_flax  # noqa: E402
from vae_training_tpu_torch.train import TrainState, adam_update_  # noqa: E402
from vae_training_tpu_torch.train import step as torch_step  # noqa: E402
from vae_training_tpu_torch.train.step import loss_terms  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16, F32 = jnp.bfloat16, jnp.float32
RHO_MAX, RHO_CONTROL = 1e-3, 0.5
# one step of lr 1e-3 moves a parameter by about as much as the modes part
# it, so the parameters' own f32 rounding sets a floor of ~3e-2 on their ρ
RHO_PARAMS = 0.1
LR, COUNT = 1e-3, 3  # a mid-run Adam state: t = 4 after the step


# --- JAX_bf16: the JAX package's model with bf16-operand layers -------------


def _q(a):
    """a rounded to bfloat16 (nearest even), as float32."""
    return a.astype(BF16).astype(F32)


@jax.custom_vjp
def _bf16_dot(a, b):
    return jnp.dot(a.astype(BF16), b.astype(BF16), preferred_element_type=F32)


def _bf16_dot_fwd(a, b):
    return _bf16_dot(a, b), (a, b)


def _bf16_dot_bwd(res, g):
    a, b = res
    return (jnp.dot(g.astype(BF16), b.astype(BF16).T, preferred_element_type=F32),
            jnp.dot(a.astype(BF16).T, g.astype(BF16), preferred_element_type=F32))


_bf16_dot.defvjp(_bf16_dot_fwd, _bf16_dot_bwd)


def _conv(x, k):  # flax nn.Conv(strides=2, padding="SAME"), NHWC · HWIO
    return jax.lax.conv_general_dilated(x, k, (2, 2), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _conv_t(x, k):  # flax nn.ConvTranspose(strides=2, padding="SAME")
    return jax.lax.conv_transpose(x, k, (2, 2), "SAME",
                                  dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _bf16_linear_op(f):
    """f(x, k), bilinear, on rounded operands; its backward takes the
    cotangent rounded and the rounded operands (the dot's rule for a conv)."""

    @jax.custom_vjp
    def op(x, k):
        return f(_q(x), _q(k))

    def fwd(x, k):
        return op(x, k), (_q(x), _q(k))

    def bwd(res, g):
        return jax.vjp(f, *res)[1](_q(g))

    op.defvjp(fwd, bwd)
    return op


_BF16_CONV, _BF16_CONV_T = _bf16_linear_op(_conv), _bf16_linear_op(_conv_t)


def _interceptor(bf16):
    """Every Dense, Conv and ConvTranspose call recomputed by hand, with
    bf16-operand products (``bf16``) or in fp32 (the sanity check)."""

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__" or not isinstance(
                mod, (nn.Dense, nn.Conv, nn.ConvTranspose)):
            return next_fun(*args, **kwargs)
        x = args[0]
        k, b = mod.get_variable("params", "kernel"), mod.get_variable("params", "bias")
        if isinstance(mod, nn.Dense):
            y = _bf16_dot(x, k) if bf16 else jnp.dot(x, k)
        elif isinstance(mod, nn.ConvTranspose):
            y = _BF16_CONV_T(x, k) if bf16 else _conv_t(x, k)
        else:
            y = _BF16_CONV(x, k) if bf16 else _conv(x, k)
        return y + b

    return intercept


def _jax_step(jm, params, mu, nu, x, z1, z2, mode):
    """One step of the JAX package's model: mode "fp32" (its own layers),
    "bf16" (JAX_bf16) or "manual" (the hand layers in fp32). Returns port-
    named numpy dicts: loss, grads, params, m, v."""

    def loss_fn(p):
        return jax_elbo_terms(x, *jm.apply({"params": p}, x, z1, z2))[0]

    ctx = (contextlib.nullcontext() if mode == "fp32"
           else nn.intercept_methods(_interceptor(mode == "bf16")))
    with ctx:
        loss, grads = jax.value_and_grad(loss_fn)(params)
    opt = make_adam(LR)
    st = opt.init(params)
    st = (st[0]._replace(count=jnp.asarray(COUNT, jnp.int32), mu=mu, nu=nu),) + tuple(st[1:])
    updates, st = opt.update(grads, st, params)
    new = optax.apply_updates(params, updates)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    out = state_from_flax(host(new), host(st[0].mu), host(st[0].nu), COUNT)
    g = state_from_flax(host(grads), host(grads), host(grads), 0).params
    return {"loss": {"loss": torch.tensor(float(loss))}, "grads": g, "params": out.params,
            "m": out.m, "v": out.v}


def _port_step(model, state, x, z1, z2):
    """The port's step (``train/step.py`` step_body's math, the noise given):
    the same five quantities."""
    params = {k: t.clone().requires_grad_(True) for k, t in state.params.items()}
    loss = loss_terms(model, params, *map(torch.as_tensor, (x, z1, z2)))[0]
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    p = {k: t.detach().clone() for k, t in params.items()}
    m = {k: t.clone() for k, t in state.m.items()}
    v = {k: t.clone() for k, t in state.v.items()}
    for k in p:
        adam_update_(p[k], m[k], v[k], grads[k], COUNT + 1, LR)
    return {"loss": {"loss": loss.detach()}, "grads": grads, "params": p, "m": m, "v": v}


def _vec(d):
    return np.concatenate([np.asarray(d[k], np.float64).ravel() for k in sorted(d)])


def _rho(port, jb, jf):
    return float(np.linalg.norm(_vec(port) - _vec(jb)) / np.linalg.norm(_vec(jf) - _vec(jb)))


def _manifold_x(kind, rs, n, dd, D):
    """A batch on the case's manifold, padded to D."""
    z = rs.randn(n, dd).astype(np.float32)
    x = np.zeros((n, D), np.float32)
    if kind == "sphere":
        x[:, :dd] = z / np.linalg.norm(z, axis=1, keepdims=True)
    elif kind == "sigmoid":
        a = rs.randn(dd, 1).astype(np.float32)
        x[:, :dd], x[:, dd:dd + 1] = z, 1 / (1 + np.exp(-(z @ a)))
    else:
        x[:, :dd] = z @ rs.randn(dd, dd).astype(np.float32).T
    return x


# name: (model kwargs (MLP) or conv kwargs, manifold, batch)
STEP_CASES = {
    "linear row 1": (dict(data_dim=12, latent_dim=20, epsilon=-1.0, tunable_decoder_var=True),
                     "linear", 100),
    "sigmoid dual": (dict(data_dim=7, latent_dim=6, epsilon=-3.0, tunable_decoder_var=True,
                          dataset_name="sigmoid"), "sigmoid", 100),
    "mlp sphere": (dict(data_dim=6, latent_dim=6, encoder_layer_sizes="16|16|16",
                        decoder_layer_sizes="16|16|16", epsilon=-3.0,
                        tunable_decoder_var=True), "sphere", 100),
    "mlp linear_gaussian": (dict(data_dim=6, latent_dim=6, encoder_layer_sizes="16|16|16",
                                 decoder_layer_sizes="16|16|16", epsilon=-1.0,
                                 tunable_decoder_var=True), "linear", 100),
    "conv": (dict(image_hwc=(8, 8, 1), latent_dim=4, channels_spec="8|16", epsilon=-1.0,
                  tunable_decoder_var=True), "image", 16),
}


def _case(name):
    kw, kind, n = STEP_CASES[name]
    rs = np.random.RandomState(sorted(STEP_CASES).index(name))
    if kind == "image":
        D, L = int(np.prod(kw["image_hwc"])), kw["latent_dim"]
        jm = jax_build_conv(**kw)
        x = np.tanh(rs.randn(n, D)).astype(np.float32)
        build = lambda dots: build_conv_vae(**kw, bf16_dots=dots)  # noqa: E731
    else:
        D, L = kw["data_dim"], kw["latent_dim"]
        jm = jax_build_vae(**kw)
        x = _manifold_x(kind, rs, n, 3, D)
        build = lambda dots: build_vae(**kw, bf16_dots=dots)  # noqa: E731
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, D)), jnp.zeros((1, L)),
                     jnp.zeros((1, D)))["params"]
    # a mid-run state: COUNT fp32 steps of the JAX package on other batches
    opt = make_adam(LR)
    st = opt.init(params)

    def loss_fn(p, x, z1, z2):
        return jax_elbo_terms(x, *jm.apply({"params": p}, x, z1, z2))[0]

    for _ in range(COUNT):
        batch = (x[rs.permutation(n)], rs.randn(n, L).astype(np.float32),
                 rs.randn(n, D).astype(np.float32))
        updates, st = opt.update(jax.grad(loss_fn)(params, *batch), st, params)
        params = optax.apply_updates(params, updates)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    z1, z2 = rs.randn(n, L).astype(np.float32), rs.randn(n, D).astype(np.float32)
    return jm, host(params), host(st[0].mu), host(st[0].nu), (x, z1, z2), build


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_flax_layers_by_hand_equal_flax_in_fp32(name):
    """JAX_bf16's hand-written layers, without the rounding, are flax's own
    layers: the reference differs from the JAX model only in the rounding."""
    jm, params, mu, nu, xs, _ = _case(name)
    ref = _jax_step(jm, params, mu, nu, *xs, "fp32")
    manual = _jax_step(jm, params, mu, nu, *xs, "manual")
    for q in ("loss", "grads", "m", "v"):
        for k in ref[q]:
            np.testing.assert_allclose(manual[q][k].numpy(), ref[q][k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {q} {k}")


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_one_step_against_jax_bf16(name):
    jm, params, mu, nu, xs, build = _case(name)
    jb = _jax_step(jm, params, mu, nu, *xs, "bf16")
    jf = _jax_step(jm, params, mu, nu, *xs, "fp32")
    state = state_from_flax(params, mu, nu, COUNT)
    for dots, bound in ((True, RHO_MAX), (False, RHO_CONTROL)):
        model = build(dots)
        assert model.bf16_dots is dots
        got = _port_step(model, state, *xs)
        for q, bf16_bound in (("loss", None), ("grads", RHO_MAX), ("m", RHO_MAX),
                              ("v", RHO_MAX), ("params", RHO_PARAMS)):
            assert set(got[q]) == set(jb[q]), (name, q)
            rho = _rho(got[q], jb[q], jf[q])
            if not dots:  # the port's fp32 path is far from JAX_bf16
                assert rho >= RHO_CONTROL, f"{name} {q} (fp32 control): rho {rho:.3e}"
            elif bf16_bound is not None:
                assert rho <= bf16_bound, f"{name} {q}: rho {rho:.3e} > {bf16_bound}"
            else:  # one scalar: held to its f32 summation floor
                np.testing.assert_allclose(float(got[q]["loss"]), float(jb[q]["loss"]),
                                           rtol=1e-6, err_msg=f"{name} loss")


# --- the helper ------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(100, 37, 20), (7, 1, 3), (0, 5, 4), (5, 0, 4), (6, 5, 0)])
def test_bf16_dot_helper_against_jax_cast_dot(m, k, n):
    rs = np.random.RandomState(m * 100 + k * 10 + n)
    a, b = rs.randn(m, k).astype(np.float32), rs.randn(k, n).astype(np.float32)
    g = rs.randn(m, n).astype(np.float32)
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    y = precision.dot(ta, tb, True)
    ga, gb = torch.autograd.grad(y, (ta, tb), torch.tensor(g))
    ref_y, vjp = jax.vjp(_bf16_dot, a, b)
    ref_ga, ref_gb = vjp(g)
    for got, ref in ((y, ref_y), (ga, ref_ga), (gb, ref_gb)):
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # float64 sums of the rounded operands: the products are exact
    q = lambda t: np.asarray(_q(jnp.asarray(t)), np.float64)  # noqa: E731
    for got, ref in ((y, q(a) @ q(b)), (ga, q(g) @ q(b).T), (gb, q(a).T @ q(g))):
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    # the mode rounds: the fp32 product differs where K > 0
    plain = precision.dot(torch.tensor(a), torch.tensor(b), False)
    assert torch.equal(plain, torch.tensor(a) @ torch.tensor(b))
    if m * k * n:
        assert not torch.equal(plain, y.detach())


def test_round_functions_and_conv_bias():
    x = torch.tensor([1.0 + 2.0 ** -9, 3.0, -1.0 - 2.0 ** -8 - 2.0 ** -10], requires_grad=True)
    r = precision.round_operand(x)
    assert r.tolist() == [1.0, 3.0, -1.0 - 2.0 ** -7]  # ties to even, then up
    (g,) = torch.autograd.grad(r, x, torch.tensor([1.0 + 2.0 ** -9, 1.0, 1.0]))
    assert g.tolist() == [1.0 + 2.0 ** -9, 1.0, 1.0]  # identity backward
    y = precision.round_grad(x)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y, x, torch.tensor([1.0 + 2.0 ** -9, 1.0, 1.0]))
    assert g.tolist() == [1.0, 1.0, 1.0]
    # a conv's bias gradient sums the cotangent unrounded, as a Dense bias's
    rs = np.random.RandomState(0)
    xin = torch.tensor(rs.randn(2, 3, 6, 6).astype(np.float32))
    w = torch.tensor(rs.randn(4, 3, 3, 3).astype(np.float32))
    bias = torch.zeros(4, requires_grad=True)
    ct = torch.tensor(rs.randn(2, 4, 2, 2).astype(np.float32))
    out = precision.conv2d(xin, w, bias, True, stride=2)
    (gb,) = torch.autograd.grad(out, bias, ct)
    torch.testing.assert_close(gb, ct.sum(dim=(0, 2, 3)), rtol=0, atol=0)


# --- the plain kernel versions -----------------------------------------------


def _noise(rs, steps, batch, D, L, x_fn):
    return (torch.tensor(np.stack([x_fn() for _ in range(steps)])),
            torch.tensor(rs.randn(steps, batch, L).astype(np.float32)),
            torch.tensor(rs.randn(steps, batch, D).astype(np.float32)))


def _torch_path(model, dataset, layout, p, m, v, steps, batch, tdv, noise, t0=0):
    """The torch path from the flat state: the plain version's reference."""
    def unflat(flat):
        d = {name: torch.empty(shape) for name, shape in layout if tdv or name != "epsilon"}
        k1.unpack_layout_(flat, d, layout)
        return d
    state = TrainState(params=unflat(p), m=unflat(m), v=unflat(v), count=t0, step=5,
                       data_seed=11, model_seed=12)
    state, losses = torch_step.train_chunk(model, dataset, state, steps, batch_size=batch,
                                           lr=LR, noise=noise)
    out = [p.clone(), m.clone(), v.clone()]
    for flat, d in zip(out, (state.params, state.m, state.v)):
        k1.repack_layout_(flat, d, layout)
    return losses, out


def _flat_state(model, layout, rs):
    model.init_parameters(3)
    named = dict(model.named_parameters())
    p = k1.pack_layout({k: t.detach() for k, t in named.items()}, layout)
    m = torch.tensor((0.01 * rs.randn(p.numel())).astype(np.float32))
    v = torch.tensor((1e-4 * rs.rand(p.numel())).astype(np.float32))
    return p, m, v


@pytest.mark.parametrize("kernel", ["K1", "K2", "K5"])
def test_plain_kernel_versions_equal_the_torch_path_in_bf16(kernel):
    rs = np.random.RandomState(4)
    steps, B = 4, 32
    if kernel == "K5":
        enc, dec = (6, 16, 16, 16, 6), (6, 16, 16, 16, 6)
        D, L, dual = 6, 6, False
        model = build_vae(data_dim=D, latent_dim=L, encoder_layer_sizes="16|16|16",
                          decoder_layer_sizes="16|16|16", epsilon=-3.0,
                          tunable_decoder_var=True, bf16_dots=True)
        dataset = SphereDataset(3, 3)
        layout = k5.param_layout(enc, dec)
        x_fn = lambda: _manifold_x("sphere", rs, B, 3, D)  # noqa: E731
    else:
        dual = kernel == "K2"
        D, L = (7, 6) if dual else (12, 20)
        a = torch.tensor(rs.randn(3, 1 if dual else 3).astype(np.float32))
        model = build_vae(data_dim=D, latent_dim=L, epsilon=-1.0, tunable_decoder_var=True,
                          dataset_name="sigmoid" if dual else None, bf16_dots=True)
        dataset = (SigmoidDataset(a, 3, D - 4, True) if dual
                   else LinearGaussianDataset(a, 3, 3, D - 3, 0.0, True))
        layout = k1.param_layout(D, L, dual)
        x_fn = lambda: _manifold_x("sigmoid" if dual else "linear", rs, B, 3, D)  # noqa: E731
    noise = _noise(rs, steps, B, D, L, x_fn)
    p, m, v = _flat_state(model, layout, rs)
    ref_losses, ref = _torch_path(model, dataset, layout, p, m, v, steps, B, True, noise)
    kw = dict(n_steps=steps, batch=B, step0=5, t0=0, data_seed=11, model_seed=12,
              var_added=0.0, tdv=True, lr=LR, external_noise=noise)
    outs = {}
    for dots in (True, False):
        bufs = [p.clone(), m.clone(), v.clone()]
        if kernel == "K5":
            losses = k5.plain_mlp_fused_chunk(*bufs, None, enc_widths=enc, dec_widths=dec,
                                              kind="sphere", intrinsic_dim=3, manifold_dim=3,
                                              eps_const=-3.0, bf16_dots=dots, **kw)
        else:
            losses = k1.plain_fused_chunk(*bufs, a, data_dim=D, latent_dim=L, intrinsic_dim=3,
                                          manifold_dim=3, eps_const=-1.0, dual=dual,
                                          bf16_dots=dots, **kw)
        outs[dots] = (losses, bufs)
    losses, bufs = outs[True]
    assert torch.equal(losses, ref_losses)
    for got, want in zip(bufs, ref):
        assert torch.equal(got, want)
    # the flag reaches the plain version: fp32 parts from it
    assert not torch.equal(outs[False][0], ref_losses)


@pytest.mark.parametrize("family", ["K6a", "K6b"])
def test_plain_grid_rows_equal_solo_plain_chunks_in_bf16(family):
    rs = np.random.RandomState(5)
    steps, B = 3, 16
    rows, states = [], []
    if family == "K6a":
        dims = [(12, 20, 3), (7, 10, 4)]
        for D, L, dd in dims:
            a = torch.tensor(rs.randn(dd, dd).astype(np.float32))
            model = build_vae(data_dim=D, latent_dim=L, epsilon=-1.0, tunable_decoder_var=True,
                              bf16_dots=True)
            states.append(_flat_state(model, k1.param_layout(D, L), rs))
            rows.append(k1.GridRow(D, L, dd, dd, a, step0=2, t0=0, data_seed=3 + D,
                                   model_seed=4))
        grid_kw = dict(n_steps=steps, batch=B, eps_const=-1.0, tdv=True, lr=LR,
                       bf16_dots=True)
        packed = [torch.cat([s[j] for s in states]) for j in range(3)]
        grid = k1.plain_grid_chunk(*packed, rows, **grid_kw)
        views = k1.row_views(*packed, rows)
        for i, (r, (p, m, v)) in enumerate(zip(rows, states)):
            bufs = [p.clone(), m.clone(), v.clone()]
            solo = k1.plain_fused_chunk(*bufs, r.a, data_dim=r.data_dim, latent_dim=r.latent_dim,
                                        intrinsic_dim=r.intrinsic_dim,
                                        manifold_dim=r.manifold_dim, step0=r.step0, t0=r.t0,
                                        data_seed=r.data_seed, model_seed=r.model_seed,
                                        var_added=0.0, **{k: v_ for k, v_ in grid_kw.items()
                                                          if k != "n_steps"},
                                        n_steps=steps)
            assert torch.equal(grid[i], solo)
            for got, want in zip(views[i], bufs):
                assert torch.equal(got, want)
    else:
        hidden = (16, 16, 16)
        for D, L in ((6, 6), (9, 4)):
            enc, dec = (D, *hidden, L), (L, *hidden, D)
            model = build_vae(data_dim=D, latent_dim=L, encoder_layer_sizes="16|16|16",
                              decoder_layer_sizes="16|16|16", epsilon=-3.0,
                              tunable_decoder_var=True, bf16_dots=True)
            states.append(_flat_state(model, k5.param_layout(enc, dec), rs))
            rows.append(k1.GridRow(D, L, 3, 3, None, step0=2, t0=0, data_seed=3 + D,
                                   model_seed=4))
        grid_kw = dict(batch=B, enc_hidden=hidden, dec_hidden=hidden, kind="sphere",
                       eps_const=-3.0, tdv=True, lr=LR, bf16_dots=True)
        packed = [torch.cat([s[j] for s in states]) for j in range(3)]
        grid = k5.plain_grid_chunk(*packed, rows, n_steps=steps, **grid_kw)
        views = k5.row_views(*packed, rows, hidden, hidden)
        for i, (r, (p, m, v)) in enumerate(zip(rows, states)):
            bufs = [p.clone(), m.clone(), v.clone()]
            enc, dec = k5.row_widths(r, hidden, hidden)
            solo = k5.plain_mlp_fused_chunk(
                *bufs, None, n_steps=steps, batch=B, enc_widths=enc, dec_widths=dec,
                kind="sphere", intrinsic_dim=3, manifold_dim=3, step0=r.step0, t0=r.t0,
                data_seed=r.data_seed, model_seed=r.model_seed, var_added=0.0,
                eps_const=-3.0, tdv=True, lr=LR, bf16_dots=True)
            assert torch.equal(grid[i], solo)
            for got, want in zip(views[i], bufs):
                assert torch.equal(got, want)


# --- the samplers and the sigmoid score --------------------------------------


def _jax_cast_dot(a, b):
    return np.asarray(jnp.dot(jnp.asarray(a).astype(BF16), jnp.asarray(b).astype(BF16),
                              preferred_element_type=F32))


def test_linear_gaussian_sample_in_bf16():
    ds = LinearGaussianDataset.create(2, dimension=3, intrinsic_dimension=3,
                                      padding_dimension=4, var_added=0.01, bf16_dots=True)
    n, seed, step = 64, 77, 9
    got = ds.sample(seed, step, n).numpy()
    lat = rng.normals(seed, step, n, rng.STREAM_MANIFOLD, 3).numpy()
    obs = rng.normals(seed, step, n, rng.STREAM_OBS, 7).numpy()
    scale = np.float32(np.sqrt(np.float32(0.01)))
    ref = np.pad(_jax_cast_dot(lat, ds.A.numpy().T), ((0, 0), (0, 4))) + obs * scale
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    fp32 = LinearGaussianDataset(ds.A, 3, 3, 4, 0.01).sample(seed, step, n).numpy()
    assert not np.array_equal(got, fp32)


def test_sigmoid_sample_and_score_in_bf16():
    ds = SigmoidDataset.create(3, dimension=3, padding_dimension=2, bf16_dots=True)
    n, seed, step = 64, 78, 4
    got = ds.sample(seed, step, n).numpy()
    z = rng.normals(seed, step, n, rng.STREAM_MANIFOLD, 3).numpy()
    sig = np.asarray(jax.nn.sigmoid(_jax_cast_dot(z, ds.A.numpy())))
    ref = np.pad(np.concatenate([z, sig], 1), ((0, 0), (0, 2)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert not np.array_equal(got, SigmoidDataset(ds.A, 3, 2).sample(seed, step, n).numpy())
    # the score's z·A on rounded operands: the JAX dataset's score on a
    # rounded A and a batch whose manifold columns are rounded (the
    # σ-coordinate, compared as it is, stays f32)
    batch = np.random.RandomState(0).randn(n, 6).astype(np.float32)
    jq = lambda a: np.asarray(_q(jnp.asarray(a)))  # noqa: E731
    jds = JaxSigmoid(A=jnp.asarray(jq(ds.A.numpy())), dim=3, padding_dim=2)
    jbatch = batch.copy()
    jbatch[:, :3] = jq(batch[:, :3])
    ref = jds.score(jnp.asarray(jbatch))
    score = ds.score(torch.tensor(batch))
    assert set(score) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(score[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    fp32 = SigmoidDataset(ds.A, 3, 2).score(torch.tensor(batch))
    assert float(fp32["Squared Norm of Manifold Dimension"]) != \
        float(score["Squared Norm of Manifold Dimension"])


# --- the CPU semantics, the resolver, the kernels line, grouping -------------


def test_resolver():
    assert bf16_dots("bf16", "cuda") and bf16_dots("bf16", torch.device("cuda", 0))
    assert not bf16_dots("bf16", "cpu") and not bf16_dots("fp32", "cuda")
    assert not bf16_dots("fp32", "cpu")
    with pytest.raises(ValueError, match="--precision"):
        bf16_dots("tf32", "cuda")


def _cli(tmp, name, precision, extra=()):
    from vae_training_tpu_torch._scripts.run import cli

    argv = [name, "--dataset", "linear_gaussian", "--encoder_layer_sizes", "16",
            "--layer_sizes", "16", "-ow", "--latent_dim", "4", "--padding_dim", "2", "-dd", "3",
            "--num_batches", "12", "--epsilon", "-1", "-tdv", "-lr", "1e-3", "--device", "cpu",
            "--n_print", "6", "--n_plot", "12", "--data_dir", str(tmp), "--precision",
            precision, *extra]
    assert cli(argv) == 0
    return np.load(os.path.join(str(tmp), name, "losses.npz"))


@pytest.mark.parametrize("kernels", ["torch", "auto"])
def test_cli_bf16_on_the_cpu_is_fp32_bitwise(tmp_path, capsys, kernels):
    """As the JAX package on its CPU: both values compute fp32 products."""
    a = _cli(tmp_path, "b", "bf16", ["--kernels", kernels])
    b = _cli(tmp_path, "f", "fp32", ["--kernels", kernels])
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    out = capsys.readouterr().out
    assert "bf16-operand dots" not in out  # the CPU resolves to fp32 products


def test_kernels_line_names_the_dot_mode(capsys):
    cfg = RunConfig(dataset="sphere", kernels="torch", device="cpu",
                    adam_dtype="bf16").validate()
    ds = SphereDataset(3, 3)
    for dots, tail in ((True, "with bf16-operand dots and bf16 Adam moments; "),
                       (False, "with bf16 Adam moments; ")):
        model = build_vae(data_dim=6, latent_dim=6, encoder_layer_sizes="16",
                          decoder_layer_sizes="16", bf16_dots=dots)
        dispatch.make_train_chunk(model, ds, cfg)
        assert tail in capsys.readouterr().out
    cfg.adam_dtype = "f32"
    dispatch.make_train_chunk(build_vae(data_dim=6, latent_dim=6, bf16_dots=True), ds, cfg)
    assert "(--kernels torch) with bf16-operand dots; eager" in capsys.readouterr().out


@pytest.mark.parametrize("family", ["linear", "mlp"])
def test_grid_rows_differing_in_precision_are_refused(family):
    sizes = "" if family == "linear" else "16"
    cfgs = [RunConfig(device="cpu", precision=p, dataset="linear_gaussian",
                      encoder_layer_sizes=sizes, layer_sizes=sizes).validate()
            for p in ("bf16", "fp32")]
    models = [build_vae(data_dim=6, latent_dim=4, encoder_layer_sizes=sizes,
                        decoder_layer_sizes=sizes) for _ in cfgs]
    datasets = [LinearGaussianDataset.create(2, dimension=3, intrinsic_dimension=3,
                                             padding_dimension=3) for _ in cfgs]
    module = k1 if family == "linear" else k5
    ok, why = module.grid_supported(models, datasets, cfgs[:1] * 2)
    assert ok, why
    ok, why = module.grid_supported(models, datasets, cfgs)
    assert not ok and "row 1 differs from row 0 in precision" in why


# --- tp over gloo in bf16 mode -----------------------------------------------

TP_MODEL = dict(data_dim=5, latent_dim=4, encoder_layer_sizes="16", decoder_layer_sizes="16",
                epsilon=-1.0, tunable_decoder_var=True)
TP_DATA = dict(seed=2, dimension=3, intrinsic_dimension=3, padding_dimension=2)
TP_RANK = textwrap.dedent("""
    import os, sys, torch, torch.distributed as dist
    from vae_training_tpu_torch.config import RunConfig
    from vae_training_tpu_torch.data import LinearGaussianDataset
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.parallel.api import make_parallel_step_fns
    from vae_training_tpu_torch.utils.process import init_distributed, process_index
    init_distributed(True, "cpu")
    inp = torch.load(os.path.join(sys.argv[1], "inputs.pt"), weights_only=False)
    model = build_vae(**inp["model"], bf16_dots=True)
    ds = LinearGaussianDataset.create(**inp["data"], bf16_dots=True)
    cfg = RunConfig(mesh="tp=2", batch_size=inp["batch"], learning_rate=inp["lr"],
                    device="cpu", kernels="torch")
    fns = make_parallel_step_fns(model, ds, cfg, graph=False, form="eager")
    local = fns.place_state(inp["state"])
    shard = tuple(local.params["Encoder.FC0.kernel"].shape)
    local, losses = fns.train_chunk(local, inp["steps"])
    full = fns.full_state(local)
    torch.save({"losses": losses, "shard": shard,
                "params": {k: t.detach().clone() for k, t in full.params.items()}},
               os.path.join(sys.argv[1], f"tp_rank{process_index()}.pt"))
    dist.destroy_process_group()
""")


def test_tp_over_gloo_in_bf16_against_the_unsharded_step(tmp_path):
    model = build_vae(**TP_MODEL, bf16_dots=True)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()),
                              data_seed=rng.derive_seed(2, rng.SEED_TRAIN_DATA),
                              model_seed=rng.derive_seed(0, rng.SEED_TRAIN_Z))
    steps, batch = 20, 32
    inputs = dict(model=TP_MODEL, data=TP_DATA, batch=batch, lr=LR, steps=steps,
                  state=TrainState({k: t.detach().clone() for k, t in state.params.items()},
                                   state.m, state.v, state.count, state.step,
                                   state.data_seed, state.model_seed))
    torch.save(inputs, os.path.join(str(tmp_path), "inputs.pt"))
    results = spawn_ranks(2, [sys.executable, "-c", TP_RANK, str(tmp_path)], timeout=120,
                          cwd=REPO, env={"PYTHONPATH": REPO})
    for r, (rc, _, err) in enumerate(results):
        assert rc == 0, f"rank {r} failed:\n{err[-4000:]}"
    got = [torch.load(os.path.join(str(tmp_path), f"tp_rank{r}.pt"), weights_only=False)
           for r in range(2)]
    ds = LinearGaussianDataset.create(**TP_DATA, bf16_dots=True)
    ref_state, ref_losses = torch_step.train_chunk(model, ds, state, steps, batch_size=batch,
                                                   lr=LR)
    np.testing.assert_allclose(got[0]["losses"].numpy(), ref_losses.numpy(), rtol=2e-3,
                               atol=2e-4)
    for k, t in ref_state.params.items():
        np.testing.assert_allclose(got[0]["params"][k].numpy(), t.detach().numpy(), rtol=5e-3,
                                   atol=5e-4, err_msg=k)
    assert all(g["shard"] == (5, 8) for g in got)  # the column-parallel FC0 kernel, halved
    for k, t in got[0]["params"].items():
        assert torch.equal(t, got[1]["params"][k]), k
