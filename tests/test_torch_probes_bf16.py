"""T3, T4 and T5 in the TPU tools' default dot mode, on the CPU: the port's
plain bf16-dot versions against the JAX tools' Pallas bodies in interpret
mode with bf16-cast dots.

The TPU tools dot at ``precision=None``
(``jnp.dot(h, w, preferred_element_type=f32)``), which on the TPU is one
pass with bfloat16 operands and f32 sums (T2's ``check_dot_modes``,
tools/check_precision.py:3-8); on the CPU JAX computes the same call in
f32. So each tool is loaded by file path (``tools/`` is no package) and,
on that module object alone, its ``jnp`` is replaced by a shim whose
``dot`` casts both operands to bfloat16 and keeps the f32 result: the TPU's
default dot (JAX_bf16). Without the shim the tool computes fp32 dots
(JAX_fp32). Nothing in ``tools/`` or ``vae_training_tpu/`` changes.

The measure is ρ = ‖port − JAX_bf16‖ / ‖JAX_fp32 − JAX_bf16‖
(tests/test_torch_precision.py); the port's fp32 plain version is the
control, at ρ ≥ 0.5. What holds, and why:

- T4 on the tool's own inputs: bitwise, every form. eye·(1 + 1e-4c) rounds
  to the identity in bf16, so every output is one exact product.
- A chain of dense dots parts between any two f32 summation orders: a
  last-bit difference flips an element's rounding to bf16 now and then,
  and a flipped element changes every output of the next dot by about a
  sixteenth of a bf16 ulp, which flips ~6% of them. One dot stays at ρ ~5e-5,
  three reach ~4e-3, eight ~0.1, twenty-four ~0.2, whatever the orders
  (``test_dense_bf16_chains_part_between_summation_orders``). So the
  dense inputs are held one dot deep, ρ ≤ 1e-3 (T4's ``check_inputs``,
  T3's inputs); the tools' whole trips and steps (T3 1 and 2 trips, T4 1
  and 2 steps) run on ``two_term_inputs``, whose every f32 sum is one
  rounding in any order, and must be bitwise.
- T5 on ``check_inputs`` (diagonal weights: one product an output until
  Adam writes the off-diagonals), tail and interleaved: h at ρ ≤ 1e-3 for
  one step, ≤ 0.1 for two; what Adam changed in w, m and v within
  ``t5.DELTA_RTOL``, the state left as it was failing that.

On CPU tensors every form of the wrappers runs the plain version, bitwise,
and counts no launch; a launch helper given CPU tensors raises instead of
falling back to a plain version. The kernels are held to these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py phases
26–28).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")

from vae_training_tpu_torch.kernels import probes  # noqa: E402
from vae_training_tpu_torch.ops.precision import bf16_round  # noqa: E402
from vae_training_tpu_torch.tools import _common  # noqa: E402
from vae_training_tpu_torch.tools import probe_adam_overlap as t5  # noqa: E402
from vae_training_tpu_torch.tools import probe_mlp_interleave as t4  # noqa: E402
from vae_training_tpu_torch.tools import probe_mxu_pipelining as t3  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = [1, 2, 4]


class _TpuDefaultDot:
    """``jax.numpy`` with the TPU's default f32 dot: operands cast to
    bfloat16, the products summed in f32."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def dot(a, b, preferred_element_type=None):
        assert preferred_element_type == jnp.float32  # the tools' every dot
        return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)


def load_tool(name, bf16):
    """A fresh module object of tools/<name>.py; with ``bf16`` its dots are
    the TPU's default (edits stay in this object)."""
    spec = importlib.util.spec_from_file_location(f"_tool_bf16_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if bf16:
        mod.jnp = _TpuDefaultDot()
    return mod


def _out(shape, n):
    return [jax.ShapeDtypeStruct(shape, jnp.float32)] * n


def tool_t4(xs, ws, n_steps, bf16, depth=None):
    """The tool's _chain_kernel in interpret mode: (chains, ROWS, W)."""
    tool = load_tool("probe_mlp_interleave", bf16)
    if depth is not None:
        tool.DEPTH = depth
    n = xs.shape[0]
    out = pl.pallas_call(tool._chain_kernel(n_steps, n),
                         out_shape=_out((probes.ROWS, probes.W), n), interpret=True)(
        *map(jnp.asarray, xs.numpy()), *map(jnp.asarray, ws.numpy()))
    return np.stack([np.asarray(o) for o in out])


def tool_t3(xs, ws, n_steps, bf16, depth=None):
    """The tool's make_kernel in interpret mode; ``depth`` cuts each trip to
    its first dots (the stack of weights cut with it)."""
    tool = load_tool("probe_mxu_pipelining", bf16)
    tool.STEPS = n_steps
    if depth is not None:
        tool.DEPTH = depth
        ws = ws[:, :depth * probes.W]
    n = xs.shape[0]
    out = pl.pallas_call(tool.make_kernel(n), out_shape=_out((probes.ROWS, probes.W), n),
                         interpret=True)(*map(jnp.asarray, xs.numpy()),
                                         *map(jnp.asarray, ws.numpy()))
    return np.stack([np.asarray(o) for o in out])


def rho(port, jb, jf):
    port, jb, jf = (np.asarray(a, np.float64) for a in (port, jb, jf))
    return float(np.linalg.norm(port - jb) / np.linalg.norm(jf - jb))


T4_KW = dict(depth=probes.T4_DEPTH, weights_per_depth=False, epilogue="clamp")
T3_KW = dict(depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm")


@pytest.mark.parametrize("form", probes.T4_FORMS)
@pytest.mark.parametrize("n_chains", CHAINS)
def test_t4_tool_inputs_match_the_tool_bitwise(n_chains, form):
    xs, ws = t4.inputs(n_chains, "cpu")
    want = tool_t4(xs, ws, 2, True)
    got = probes.chain_chunk(xs, ws, n_steps=2, form=form, bf16_dots=True, **T4_KW)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, bf16_round(xs).numpy())  # one exact product an output
    fp32 = probes.chain_chunk(xs, ws, n_steps=2, form=form, **T4_KW).numpy()
    assert not np.array_equal(fp32, want)  # 0.01(c + 1) is no bf16 value


@pytest.mark.parametrize("probe", ["T4", "T3"])
@pytest.mark.parametrize("n_chains", CHAINS)
def test_dense_chains_one_dot_deep_match_the_tool_by_rho(probe, n_chains):
    """Dense random inputs (T4's check_inputs, T3's inputs), each trip cut
    to one dot: ρ ≤ 1e-3; the fp32 plain version ρ ≥ 0.5."""
    if probe == "T4":
        xs, ws = t4.check_inputs(n_chains, "cpu")
        jb, jf = (tool_t4(xs, ws, 1, bf, depth=1) for bf in (True, False))
        kw = dict(T4_KW, depth=1)
    else:
        xs, ws = t3.inputs(n_chains, "cpu")
        jb, jf = (tool_t3(xs, ws, 1, bf, depth=1) for bf in (True, False))
        ws = ws[:, :probes.W].contiguous()
        kw = dict(T3_KW, depth=1)
    got = probes.chain_chunk(xs, ws, n_steps=1, bf16_dots=True, **kw).numpy()
    ctrl = probes.chain_chunk(xs, ws, n_steps=1, **kw).numpy()
    assert rho(got, jb, jf) <= 1e-3
    assert rho(ctrl, jb, jf) >= 0.5


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("probe", ["T4", "T3"])
@pytest.mark.parametrize("n_chains", CHAINS)
def test_two_term_chains_match_the_tool_bitwise(probe, n_chains, n_steps):
    """The tools' whole steps (T4: 24 dots and the clamp) and trips (T3: 8
    dots and the renorm), 1 and 2 of them, on two_term_inputs: bitwise in
    every form; the fp32 plain version at ρ ≥ 0.5."""
    tool, mod, kw, forms = ((tool_t4, t4, T4_KW, probes.T4_FORMS) if probe == "T4"
                            else (tool_t3, t3, T3_KW, probes.T3_FORMS))
    xs, ws = mod.two_term_inputs(n_chains, "cpu")
    jb, jf = tool(xs, ws, n_steps, True), tool(xs, ws, n_steps, False)
    for form in forms:
        got = probes.chain_chunk(xs, ws, n_steps=n_steps, form=form, bf16_dots=True, **kw)
        np.testing.assert_array_equal(got.numpy(), jb, err_msg=form)
    ctrl = probes.chain_chunk(xs, ws, n_steps=n_steps, **kw).numpy()
    assert rho(ctrl, jb, jf) >= 0.5


def test_dense_bf16_chains_part_between_summation_orders():
    """Why the tools' whole trips run on two_term_inputs: the same bf16 chain
    (T4's check_inputs) with its f32 sums in float64 and then rounded, in
    place of torch's order, is ρ ≤ 1e-3 from it one dot deep and ρ > 0.05
    eight dots deep; on two_term_inputs the two orders agree bitwise."""
    def chain(xs, ws, depth, wide):
        h = xs
        for _ in range(depth):
            a, w = bf16_round(h), bf16_round(ws)
            h = (a.double() @ w.double()).float() if wide else a @ w
            h = torch.clamp(h, max=probes.CLAMP)
        return h.numpy()

    xs, ws = t4.check_inputs(2, "cpu")
    fp32 = [probes.plain_chain_chunk(xs, ws, n_steps=1, **dict(T4_KW, depth=d)).numpy()
            for d in (1, 8)]
    assert rho(chain(xs, ws, 1, True), chain(xs, ws, 1, False), fp32[0]) <= 1e-3
    assert rho(chain(xs, ws, 8, True), chain(xs, ws, 8, False), fp32[1]) > 0.05
    xs, ws = t4.two_term_inputs(2, "cpu")
    np.testing.assert_array_equal(chain(xs, ws, 24, True), chain(xs, ws, 24, False))


def test_two_term_weights_hold_two_products_a_column_in_distinct_k16_blocks():
    w = _common.two_term_weights(np.random.RandomState(5), 3)
    assert w.shape == (3 * probes.W, probes.W)
    for b in range(3):
        blk = w[b * probes.W:(b + 1) * probes.W]
        rows, cols = np.nonzero(blk)
        assert np.array_equal(np.bincount(cols, minlength=probes.W), np.full(probes.W, 2))
        for j in range(probes.W):
            r = rows[cols == j]
            assert r[0] // 16 != r[1] // 16
    w32 = torch.as_tensor(w.astype(np.float32))
    nz = w32 != 0
    assert not torch.equal(bf16_round(w32)[nz], w32[nz])  # the modes differ


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("interleave", [False, True], ids=["tail", "interleaved"])
def test_t5_matches_the_tool(interleave, n_steps):
    """T5 on check_inputs in bf16 dots: h at ρ ≤ 1e-3 (one step) or ≤ 0.1
    (two) of JAX_bf16, the fp32 control at ρ ≥ 0.5; what Adam changed in w,
    m and v within DELTA_RTOL of the tool's change; the state left as it
    was fails that."""
    outs = {}
    for bf16 in (True, False):
        tool = load_tool("probe_adam_overlap", bf16)
        x, ws, ms, vs = t5.check_inputs("cpu")
        jin = [jnp.asarray(a) for a in (x.numpy(), *ws.numpy(), *ms.numpy(), *vs.numpy())]
        outs[bf16] = [np.array(a) for a in pl.pallas_call(
            tool._kernel(n_steps, interleave),
            out_shape=_out((probes.ROWS, probes.W), 1) + _out((probes.W, probes.W), 15),
            interpret=True)(*jin)]
    want = outs[True]
    refs = [torch.as_tensor(np.stack(want[1 + 5 * k:6 + 5 * k])) for k in range(3)]
    kb, cb = t5.check_inputs("cpu"), t5.check_inputs("cpu")
    start = tuple(t.clone() for t in kb)
    h = probes.adam_overlap_chunk(*kb, n_steps=n_steps, interleave=interleave, bf16_dots=True)
    ctrl = probes.adam_overlap_chunk(*cb, n_steps=n_steps, interleave=interleave)
    assert rho(h.numpy(), want[0], outs[False][0]) <= (1e-3 if n_steps == 1 else 0.1)
    assert rho(ctrl.numpy(), want[0], outs[False][0]) >= 0.5
    for name, got, ref, s0 in zip("wmv", kb[1:], refs, start[1:]):
        assert t5.delta_mismatch(got, ref, s0) <= t5.DELTA_RTOL, name
        assert t5.delta_mismatch(s0, ref, s0) > 100 * t5.DELTA_RTOL, name


@pytest.mark.parametrize("n_chains", CHAINS)
def test_every_form_on_cpu_tensors_is_the_plain_bf16_version(n_chains):
    """On CPU tensors each form with bf16_dots is the plain bf16 version,
    bitwise, launches nothing, and computes another chain than fp32."""
    names = ("launches", "bf16_launches", "cluster_launches", "bf16_cluster_launches",
             "stream_launches", "bf16_stream_launches")
    before = [getattr(probes.chain_chunk, n) for n in names]
    for mod, kw, forms, n_steps in ((t4, T4_KW, probes.T4_FORMS, 1),
                                    (t3, T3_KW, probes.T3_FORMS, 2)):
        xs, ws = mod.two_term_inputs(n_chains, "cpu")
        want = probes.plain_chain_chunk(xs, ws, n_steps=n_steps, bf16_dots=True, **kw)
        for form in forms:
            got = probes.chain_chunk(xs, ws, n_steps=n_steps, form=form, bf16_dots=True, **kw)
            assert torch.equal(got, want), form
        assert not torch.equal(want, probes.plain_chain_chunk(xs, ws, n_steps=n_steps, **kw))
    assert [getattr(probes.chain_chunk, n) for n in names] == before


@pytest.mark.parametrize("interleave", [False, True], ids=["tail", "interleaved"])
def test_t5_forms_on_cpu_tensors_are_the_plain_bf16_version(interleave):
    names = ("launches", "bf16_launches", "stream_launches", "bf16_stream_launches")
    before = [getattr(probes.adam_overlap_chunk, n) for n in names]
    runs = []
    for form in probes.T5_FORMS + (None,):
        kb = t5.check_inputs("cpu")
        fn = (probes.plain_adam_overlap_chunk if form is None
              else lambda *a, **k: probes.adam_overlap_chunk(*a, form=form, **k))
        runs.append((fn(*kb, n_steps=2, interleave=interleave, bf16_dots=True), *kb[1:]))
    for run in runs[:-1]:
        assert all(torch.equal(p, q) for p, q in zip(run, runs[-1]))
    assert [getattr(probes.adam_overlap_chunk, n) for n in names] == before


def test_plain_bf16_dot_rounds_both_operands_to_nearest_even():
    """One dot of the plain version: both operands rounded to bfloat16 (ties
    to even: 1 + 2⁻⁸ → 1, 1 + 3·2⁻⁸ → 1 + 2⁻⁶), then f32 sums of exact
    products, within float32 summation of a float64 product."""
    tie = 1.0 + 2.0 ** -8
    xs = torch.full((1, probes.ROWS, probes.W), tie)
    xs[0, :, 1] = 1.0 + 3 * 2.0 ** -8
    ws = torch.zeros(1, probes.W, probes.W)
    ws[0, 0, 0] = ws[0, 1, 1] = tie
    kw = dict(T4_KW, depth=1)
    got = probes.plain_chain_chunk(xs, ws, n_steps=1, bf16_dots=True, **kw)
    assert torch.all(got[0, :, 0] == 1.0) and torch.all(got[0, :, 1] == 1.0 + 2.0 ** -6)
    rs = np.random.RandomState(2)
    xs = torch.as_tensor(rs.randn(2, probes.ROWS, probes.W).astype(np.float32))
    ws = torch.as_tensor(rs.randn(2, probes.W, probes.W).astype(np.float32) * 0.05)
    got = probes.plain_chain_chunk(xs, ws, n_steps=1, bf16_dots=True, **dict(kw, epilogue="renorm"))
    ref = bf16_round(xs).double() @ bf16_round(ws).double()
    ref = ref / ref.abs().amax(dim=(1, 2), keepdim=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


def test_launch_helpers_on_cpu_tensors_raise_rather_than_fall_back():
    """The bf16 launches have no plain path: given CPU tensors (here, no
    card and no nvcc) each helper raises; only the wrappers take the plain
    version, and only for CPU tensors. A device neither CPU nor CUDA is
    refused."""
    xs, ws = t4.inputs(1, "cpu")
    x3, w3 = t3.inputs(1, "cpu")
    x, w, m, v = t5.inputs("cpu")
    calls = [lambda: probes._chain_cluster_launch(xs, ws, 1, 1, bf16_dots=True),
             lambda: probes._stream_launch("t3", x3, w3, None, None, 1, bf16_dots=True),
             lambda: probes._stream_launch("tail", x[None], w, m, v, 1, bf16_dots=True)]
    for call in calls:
        with pytest.raises((RuntimeError, OSError)):
            call()
    meta = torch.zeros(1, probes.ROWS, probes.W, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA tensors"):
        probes.chain_chunk(meta, ws.to("meta"), n_steps=1, bf16_dots=True, **T4_KW)
    with pytest.raises(ValueError, match="CPU or CUDA tensors"):
        probes.adam_overlap_chunk(x.to("meta"), w.to("meta"), m.to("meta"), v.to("meta"),
                                  n_steps=1, interleave=False, bf16_dots=True)


@pytest.mark.parametrize("tool, forms, labels", [
    (t4, probes.T4_FORMS, t4.ORDER), (t3, probes.T3_FORMS, (1, 2, 4)),
    (t5, probes.T5_FORMS, t5.ORDER)], ids=["T4", "T3", "T5"])
def test_tools_run_both_dot_modes_in_turn(tool, forms, labels, monkeypatch, capsys):
    """Each tool times each form in the TPU tools' bf16 dots, then in fp32,
    and keys its report by mode, then form; no flag picks a mode."""
    calls = []

    def fake_run(device, form, which, min_seconds, bf16_dots=False):
        calls.append((form, bf16_dots, which))
        us = 2.0 if bf16_dots else 3.0
        return (us, 1, 0.0) if tool is not t3 else (us * which, 1)

    monkeypatch.setattr(tool, "run", fake_run)
    report = tool.main(["--device", "cpu"])
    assert list(report) == ["bf16", "fp32"] and all(list(r) == list(forms)
                                                    for r in report.values())
    want = [(f, bf16, lab if tool is not t5 else lab == "interleaved")
            for f in forms for bf16 in (True, False) for lab in labels]
    assert calls == want
    out = capsys.readouterr().out
    assert sum(line.startswith("VERDICT (") for line in out.splitlines()) == 2 * len(forms)
    with pytest.raises(SystemExit):
        tool.main(["--device", "cpu", "--precision", "fp32"])
