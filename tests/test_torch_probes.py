"""T1–T5, the probes, on the CPU: the port's plain versions against the JAX
tools' Pallas bodies.

The same numpy-made inputs go through the tool's Pallas kernel in
interpret mode (the tool module loaded by file path: ``tools/`` is no
package) and through the port's wrapper on CPU tensors, which runs its
plain PyTorch version. Tolerances:

- T4 (``_chain_kernel``): rtol 1e-6. Every dot is by a diagonal weight,
  one rounded product and exact zeros, so both sides round alike. On
  random inputs (``check_inputs``), rtol 1e-4, atol 1e-5, as T3.
- T3 (``make_kernel``, 2 trips): rtol 1e-4, atol 1e-5: 256-term sums in
  another order, through 16 dots and two renormalisations.
- T5 (``_kernel``, 2 steps, both variants, on ``check_inputs``): h at
  tests/test_mlp_kernel.py's params tolerance; what Adam changed in w, m
  and v at rtol 1e-3, atol 1e-3 of the tool's largest change. The tool
  takes Adam's 1 − βᵗ as 1 − exp(t·log β) in float32, the port (as its
  kernels do) as
  1 − β**t in double rounded once; at t = 1 that moves 1 − β² by up to
  ~6e-5 relatively (``test_t5_bias_corrections_differ_only_by_rounding``),
  which moves each update by as much relatively, under that rtol.
- T2: the fp32 mode against ``jnp.dot(precision=HIGHEST)``, the bf16 mode
  against ``jnp.dot`` of bf16 operands with f32 sums, rtol 1e-5 / atol
  1e-4; the TF32 rounding against a float64 rounding, ties and the low 13
  bits included.
- T1: the battery passes on the sampler's plain version (``ops/rng.py``) at
  the tool's sizes, where its bounds sit at ≥ 5σ; it fails on a stream
  that repeats a step and on two rows with one key.

The kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 26–30).
"""

import ast
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")

from vae_training_tpu_torch.kernels import probes  # noqa: E402
from vae_training_tpu_torch.ops import rng  # noqa: E402
from vae_training_tpu_torch.tools import check_kernel_rng as t1  # noqa: E402
from vae_training_tpu_torch.tools import check_precision as t2  # noqa: E402
from vae_training_tpu_torch.tools import probe_adam_overlap as t5  # noqa: E402
from vae_training_tpu_torch.tools import probe_mlp_interleave as t4  # noqa: E402
from vae_training_tpu_torch.tools import probe_mxu_pipelining as t3  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_TOL = {"params": (1e-3, 1e-5), "m": (1e-3, 1e-6), "v": (1e-3, 1e-9)}


def load_tool(name):
    """A fresh module object of tools/<name>.py (edits stay in this test)."""
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def f32(shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


@pytest.fixture(scope="module")
def tool_t4():
    return load_tool("probe_mlp_interleave")


@pytest.mark.parametrize("form", probes.T4_FORMS)
@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_t4_chains_match_the_tool(tool_t4, n_chains, form):
    assert (tool_t4.ROWS, tool_t4.W, tool_t4.DEPTH) == (probes.ROWS, probes.W, probes.T4_DEPTH)
    xs, ws = t4.inputs(n_chains, "cpu")
    want = pl.pallas_call(tool_t4._chain_kernel(2, n_chains),
                          out_shape=[f32((probes.ROWS, probes.W))] * n_chains, interpret=True)(
        *map(jnp.asarray, xs.numpy()), *map(jnp.asarray, ws.numpy()))
    got = probes.chain_chunk(xs, ws, n_steps=2, depth=probes.T4_DEPTH, weights_per_depth=False,
                             epilogue="clamp", form=form)
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(w) for w in want]), rtol=1e-6)


@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_t4_random_chains_match_the_tool(tool_t4, n_chains):
    """T4's chain on random inputs (``check_inputs``: the clamp reached,
    every term of each dot nonzero), 1 step of the tool's 24 dots: rtol
    1e-4, atol 1e-5, T3's, for sums taken in another order."""
    xs, ws = t4.check_inputs(n_chains, "cpu")
    want = pl.pallas_call(tool_t4._chain_kernel(1, n_chains),
                          out_shape=[f32((probes.ROWS, probes.W))] * n_chains, interpret=True)(
        *map(jnp.asarray, xs.numpy()), *map(jnp.asarray, ws.numpy()))
    got = probes.chain_chunk(xs, ws, n_steps=1, depth=probes.T4_DEPTH, weights_per_depth=False,
                             epilogue="clamp")
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(w) for w in want]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_t3_chains_match_the_tool(n_chains):
    tool = load_tool("probe_mxu_pipelining")
    tool.STEPS = 2
    assert (tool.M, tool.K, tool.DEPTH) == (probes.ROWS, probes.W, probes.T3_DEPTH)
    xs, ws = t3.inputs(n_chains, "cpu")
    want = pl.pallas_call(tool.make_kernel(n_chains),
                          out_shape=[f32((probes.ROWS, probes.W))] * n_chains, interpret=True)(
        *map(jnp.asarray, xs.numpy()), *map(jnp.asarray, ws.numpy()))
    got = probes.chain_chunk(xs, ws, n_steps=2, depth=probes.T3_DEPTH, weights_per_depth=True,
                             epilogue="renorm")
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(w) for w in want]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("interleave", [False, True], ids=["tail", "interleaved"])
def test_t5_steps_match_the_tool(interleave):
    """What Adam changed (w, m and v less their start) held to the tool's
    change at rtol 1e-3, atol 1e-3 of its own largest change, on inputs
    where Adam's arithmetic shows (``check_inputs``). The same comparison
    must fail for the state left as it was (Adam dropped) and for the
    other variant (gradients from another h)."""
    tool = load_tool("probe_adam_overlap")
    assert (tool.ROWS, tool.W, tool.N_BUF, tool.DOTS_PER_BUF) == (
        probes.ROWS, probes.W, probes.N_BUF, probes.DOTS_PER_BUF)
    assert (tool.B1, tool.B2, tool.EPS) == (probes.B1, probes.B2, probes.EPS)
    x, ws, ms, vs = t5.check_inputs("cpu")
    start = tuple(t.clone() for t in (ws, ms, vs))
    jin = [jnp.asarray(a) for a in (x.numpy(), *ws.numpy(), *ms.numpy(), *vs.numpy())]
    want = [np.array(a) for a in pl.pallas_call(
        tool._kernel(2, interleave),
        out_shape=[f32((probes.ROWS, probes.W))] + [f32((probes.W, probes.W))] * 15,
        interpret=True)(*jin)]
    refs = [torch.as_tensor(np.stack(want[1 + 5 * k:6 + 5 * k])) for k in range(3)]
    h = probes.adam_overlap_chunk(x, ws, ms, vs, n_steps=2, interleave=interleave)
    np.testing.assert_allclose(h.numpy(), want[0], *MLP_TOL["params"])
    other = t5.check_inputs("cpu")
    probes.adam_overlap_chunk(*other, n_steps=2, interleave=not interleave)
    for name, got, ref, s0, o in zip("wmv", (ws, ms, vs), refs, start, other[1:]):
        assert t5.delta_mismatch(got, ref, s0) <= t5.DELTA_RTOL, name
        assert t5.delta_mismatch(s0, ref, s0) > 100 * t5.DELTA_RTOL, name
        assert t5.delta_mismatch(o, ref, s0) > 10 * t5.DELTA_RTOL, name


def test_t5_bias_corrections_differ_only_by_rounding():
    """The tool's float32 1 − exp(t·log β) against the port's 1 − β**t in
    double rounded to float32: at most 6e-5 relatively (t = 1, 2)."""
    for t in (1, 2):
        for beta in (probes.B1, probes.B2):
            tool = 1.0 - float(jnp.exp(jnp.float32(t) * math.log(beta)))
            port = float(np.float32(1.0 - beta ** t))
            assert abs(tool - port) <= 6e-5 * port


def test_t5_variants_differ():
    """The tail's gradients come from the final h, the interleaved ones
    from h after dot 5d + 4: the variants compute different updates."""
    out = {}
    for interleave in (False, True):
        x, ws, ms, vs = t5.inputs("cpu")
        probes.adam_overlap_chunk(x, ws, ms, vs, n_steps=1, interleave=interleave)
        out[interleave] = ms
    assert not torch.equal(out[False][:4], out[True][:4])
    assert torch.equal(out[False][4], out[True][4])  # the last buffer: h after dot 24 in both


def test_t2_fp32_and_bf16_modes_match_jax():
    x, w = t2.inputs("cpu")
    jx, jw = jnp.asarray(x.numpy()), jnp.asarray(w.numpy())
    highest = np.asarray(jnp.dot(jx, jw, precision=jax.lax.Precision.HIGHEST,
                                 preferred_element_type=jnp.float32))
    cast = np.asarray(jnp.dot(jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    np.testing.assert_allclose(probes.dot_modes(x, w, "fp32").numpy(), highest,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(probes.dot_modes(x, w, "bf16").numpy(), cast,
                               rtol=1e-5, atol=1e-4)
    ref = x.double() @ w.double()
    tf32 = probes.round_tf32(x).double() @ probes.round_tf32(w).double()
    np.testing.assert_allclose(probes.dot_modes(x, w, "tf32").numpy(), tf32.numpy(),
                               rtol=1e-5, atol=1e-4)
    errs = [float((probes.dot_modes(x, w, m).double() - ref).abs().max())
            for m in ("fp32", "tf32", "bf16")]
    assert errs[0] < errs[2] / 100 and errs[0] < errs[1] < errs[2]


def _tf32_float64(a: np.ndarray) -> np.ndarray:
    """Round to 10 mantissa bits, ties away from zero, in float64."""
    out = np.empty_like(a, dtype=np.float64)
    for i, v in enumerate(a.astype(np.float64)):
        if v == 0 or not np.isfinite(v):
            out[i] = v
            continue
        ulp = 2.0 ** (math.floor(math.log2(abs(v))) - 10)
        out[i] = math.copysign(math.floor(abs(v) / ulp + 0.5) * ulp, v)
    return out


def test_round_tf32_is_nearest_ties_away_with_13_low_bits_zero():
    one_ulp = 2.0 ** -10
    ties = np.array([1 + 0.5 * one_ulp, 1 + 1.5 * one_ulp, -(1 + 0.5 * one_ulp),
                     2 * (1 + 2.5 * one_ulp), 2.0 ** -120 * (1 + 0.5 * one_ulp)], np.float32)
    rs = np.random.RandomState(3)
    a = np.concatenate([ties, rs.randn(5000).astype(np.float32) * 10.0 ** rs.randint(-8, 8, 5000),
                        np.array([0.0, -0.0, 1.0, 65504.0], np.float32)]).astype(np.float32)
    got = probes.round_tf32(torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), _tf32_float64(a))
    assert np.all(got.view(np.uint32) & 0x1FFF == 0)
    np.testing.assert_array_equal(got[:5], np.array(
        [1 + one_ulp, 1 + 2 * one_ulp, -(1 + one_ulp), 2 * (1 + 3 * one_ulp),
         2.0 ** -120 * (1 + one_ulp)], np.float32))
    inf = probes.round_tf32(torch.tensor([float("inf"), float("nan")]))
    assert math.isinf(inf[0]) and math.isnan(inf[1])


def test_t1_battery_passes_on_the_plain_sampler(capsys):
    assert t1.battery(t1.plain_draw)
    out = capsys.readouterr().out
    assert out.count("PASS") == 1 + 4 + 4 + 1 + 1 + 1 and "FAIL" not in out
    assert "n=4194304" in out and "n=1048576" in out and "n=262144" in out


def test_t1_battery_fails_on_a_repeated_step(capsys):
    def repeats(seed, step, rows, stream, n_draws):
        return t1.plain_draw(seed, step // 2, rows, stream, n_draws)

    assert not t1.cross_step_battery(repeats, t1.SIZES["lag_rows"], t1.SIZES["lag_steps"])
    assert "lag-1 autocorrelation" in capsys.readouterr().out


def test_t1_battery_fails_on_two_rows_with_one_key(capsys):
    seeds = list(t1.ROW_SEEDS[:-1]) + [t1.ROW_SEEDS[0]]
    assert not t1.cross_row_battery(t1.plain_draw, t1.SIZES["row_rows"], seeds)
    assert "15 distinct" in capsys.readouterr().out


def test_t1_streams_and_rows_are_keyed_as_the_kernels():
    assert (rng.STREAM_MANIFOLD, rng.STREAM_Z1, rng.STREAM_Z2, rng.STREAM_OBS) == (0, 1, 2, 3)
    w = t1.plain_draw(rng.derive_seed(7, rng.SEED_TRAIN_DATA), 3, 5, rng.STREAM_Z2, 2)
    assert torch.equal(w, rng.normals(rng.derive_seed(7, rng.SEED_TRAIN_DATA), 3, 5,
                                      rng.STREAM_Z2, 8))


@pytest.mark.parametrize("tool, verdicts", [
    (t4, [f"VERDICT ({f}, {m} dots): 2-chain cost ratio" for f in ("phase", "cluster")
          for m in ("bf16", "fp32")]),
    (t3, [f"VERDICT ({f}, {m} dots): independence speedup: x2=" for f in ("phase", "stream")
          for m in ("bf16", "fp32")]),
    (t5, [f"VERDICT ({f}, {m} dots): interleaved/tail = " for f in ("phase", "stream")
          for m in ("bf16", "fp32")]),
    (t2, ["RESULT: PASS"])],
    ids=["T4", "T3", "T5", "T2"])
def test_tools_run_on_the_cpu(tool, verdicts, capsys):
    """Each tool runs on the CPU's plain versions and prints its verdicts:
    T3, T4 and T5 one a form and dot mode, the TPU tools' bf16 dots first."""
    tool.main(["--device", "cpu", "--seconds", "0.005"])
    out = capsys.readouterr().out
    assert out.startswith("card: cpu (host-clock times")
    assert all(v in out for v in verdicts)
    at = [out.index(v) for v in verdicts]
    assert at == sorted(at)


@pytest.mark.parametrize("tool", [t1, t2, t3, t4, t5], ids=["T1", "T2", "T3", "T4", "T5"])
def test_tools_refuse_cuda_without_a_gpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda but no CUDA device"):
        tool.main([])


def test_wrappers_check_shapes():
    xs, ws = t4.inputs(2, "cpu")
    with pytest.raises(ValueError, match="ws must be"):
        probes.chain_chunk(xs, ws, n_steps=1, depth=8, weights_per_depth=True, epilogue="clamp")
    with pytest.raises(ValueError, match="cluster form is T4's"):
        probes.chain_chunk(xs, ws, n_steps=1, depth=8, weights_per_depth=False,
                           epilogue="renorm", form="cluster")
    with pytest.raises(ValueError, match="xs must be"):
        probes.chain_chunk(torch.zeros(5, 104, 256), ws, n_steps=1, depth=8,
                           weights_per_depth=False, epilogue="clamp")
    with pytest.raises(ValueError, match="mode must be"):
        probes.dot_modes(torch.zeros(16, 16), torch.zeros(16, 8), "fp16")
    # the stream form is T3's and T5's: T4's chain, a depth other than the
    # 8 weights, the clamp, and a form T5 has not are refused
    with pytest.raises(ValueError, match="stream form is T3's"):
        probes.chain_chunk(xs, ws, n_steps=1, depth=8, weights_per_depth=False,
                           epilogue="clamp", form="stream")
    x3, w3 = t3.inputs(2, "cpu")
    with pytest.raises(ValueError, match="stream form is T3's"):
        probes.chain_chunk(x3, w3[:, :4 * probes.W], n_steps=1, depth=4, weights_per_depth=True,
                           epilogue="renorm", form="stream")
    with pytest.raises(ValueError, match="stream form is T3's"):
        probes.chain_chunk(x3, w3, n_steps=1, depth=8, weights_per_depth=True,
                           epilogue="clamp", form="stream")
    with pytest.raises(ValueError, match="form must be one of"):
        probes.chain_chunk(x3, w3, n_steps=1, depth=8, weights_per_depth=True,
                           epilogue="renorm", form="tile")
    kb = t5.inputs("cpu")
    for form in ("cluster", "tile"):
        with pytest.raises(ValueError, match="form must be one of"):
            probes.adam_overlap_chunk(*kb, n_steps=1, interleave=False, form=form)
    with pytest.raises(ValueError, match="ms must be"):
        probes.adam_overlap_chunk(kb[0], kb[1], kb[2][:4], kb[3], n_steps=1, interleave=False,
                                  form="stream")


@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_t3_stream_form_runs_the_plain_version_on_the_cpu(n_chains):
    """On CPU tensors the stream form is the plain version (bitwise the
    phase form's) and launches nothing; the tool's Pallas body agrees."""
    tool = load_tool("probe_mxu_pipelining")
    tool.STEPS = 2
    xs, ws = t3.inputs(n_chains, "cpu")
    kw = dict(n_steps=2, depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm")
    before = probes.chain_chunk.stream_launches
    got = probes.chain_chunk(xs, ws, form="stream", **kw)
    assert probes.chain_chunk.stream_launches == before
    assert torch.equal(got, probes.chain_chunk(xs, ws, form="phase", **kw))
    want = pl.pallas_call(tool.make_kernel(n_chains),
                          out_shape=[f32((probes.ROWS, probes.W))] * n_chains, interpret=True)(
        *map(jnp.asarray, xs.numpy()), *map(jnp.asarray, ws.numpy()))
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(w) for w in want]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("interleave", [False, True], ids=["tail", "interleaved"])
def test_t5_stream_form_runs_the_plain_version_on_the_cpu(interleave):
    """On CPU tensors T5's stream form updates w, m and v as the phase form
    does, bitwise (both are the plain version), and launches nothing."""
    a, b = t5.check_inputs("cpu"), t5.check_inputs("cpu")
    before = probes.adam_overlap_chunk.stream_launches
    ha = probes.adam_overlap_chunk(*a, n_steps=2, interleave=interleave, form="stream")
    hb = probes.adam_overlap_chunk(*b, n_steps=2, interleave=interleave, form="phase")
    assert probes.adam_overlap_chunk.stream_launches == before
    assert torch.equal(ha, hb) and all(torch.equal(p, q) for p, q in zip(a[1:], b[1:]))


def test_probes_import_nothing_of_the_jax_tools():
    """The port's tools keep their own constants: no import of the repo's
    tools/ (nor of JAX, which tests/test_torch_sweep.py checks)."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "vae_training_tpu_torch", "kernels", "probes.py")]
    tools_dir = os.path.join(REPO, "vae_training_tpu_torch", "tools")
    files += [os.path.join(tools_dir, n) for n in os.listdir(tools_dir) if n.endswith(".py")]
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] != "tools", (path, node.module)
            elif isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] != "tools" for a in node.names), path
