"""T4's cluster form (csrc/probes.cu chain_cluster_kernel) planned on the CPU.

``kernels/probes.py:chain_plan`` mirrors the library's constants (the
launch takes only the chain count and the dot mode), and ``chain_cta`` is
the kernel's index arithmetic for one CTA. For 1, 2 and 4
chains: every (chain, row, column) output is owned by exactly one CTA, each
CTA's push reaches exactly the other CTAs of its row group (which together
hold the rest of its rows' columns), a CTA's warps' K slices cover K once,
the shared memory fits 232,448 bytes, the cluster is at most 16 CTAs and 4
chains take at most the card's 132 SMs.

A plain emulation of the plan (each CTA's own copy of its rows of h, each
warp's partial product over its K slice in float32, the 8 partials summed
in K order, the clamp, the rows written into the CTA's own next h and its
peers') run for 3 steps equals ``plain_chain_chunk`` and the JAX tool's
``_chain_kernel`` (interpret mode, the tool loaded by file path) at
``chip_smoke.py`` phase 26's tolerances: rtol 1e-6 on the tool's inputs
(diagonal weights: one nonzero term an output, so every order rounds
alike), rtol 1e-4 / atol 1e-5 on ``check_inputs`` (sums in another order);
and on ``check_inputs`` over 8 dots, where the values are still large. An
emulation that pushes to no peer fails that comparison. Inputs come from
numpy seeds.
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
from vae_training_tpu_torch.tools import probe_mlp_interleave as t4  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM_LIMIT = 232448
CARD_SMS = 132
CHAINS = (1, 2, 4)


def _ctas(plan):
    return [probes.chain_cta(plan, b) for b in range(plan.grid)]


@pytest.mark.parametrize("n_chains", CHAINS)
def test_plan_owns_every_output_once(n_chains):
    plan = probes.chain_plan(n_chains)
    assert plan.grid == n_chains * plan.cluster
    assert plan.row_groups * plan.col_slices == plan.cluster
    own = np.zeros((n_chains, probes.ROWS, probes.W), np.int64)
    for cta in _ctas(plan):
        (r0, r1), (c0, c1) = cta["rows"], cta["cols"]
        assert (r1 - r0, c1 - c0) == (plan.rows, plan.cols)
        own[cta["chain"], r0:r1, c0:c1] += 1
    assert np.all(own == 1)


@pytest.mark.parametrize("n_chains", CHAINS)
def test_push_reaches_exactly_the_row_group(n_chains):
    plan = probes.chain_plan(n_chains)
    ctas = _ctas(plan)
    for cta in ctas:
        mates = {o["rank"] for o in ctas
                 if o["chain"] == cta["chain"] and o["rows"] == cta["rows"]} - {cta["rank"]}
        assert sorted(cta["peers"]) == sorted(mates) and len(cta["peers"]) == plan.col_slices - 1
        # its own columns and what its row group pushes to it make whole rows
        cols = np.zeros(probes.W, np.int64)
        for o in ctas:
            if o["chain"] == cta["chain"] and (o is cta or cta["rank"] in o["peers"]):
                cols[o["cols"][0]:o["cols"][1]] += 1
        assert np.all(cols == 1)


@pytest.mark.parametrize("n_chains", CHAINS)
def test_plan_fits_the_card(n_chains):
    plan = probes.chain_plan(n_chains)
    assert plan.smem <= SMEM_LIMIT and plan.cluster <= 16 and plan.threads == 256
    assert probes.chain_plan(4).grid <= CARD_SMS
    for cta in _ctas(plan):
        # the warps' K slices cover K once; a lane holds 4 columns of each
        cover = np.zeros(probes.W, np.int64)
        for k0, k1 in cta["k_slices"]:
            cover[k0:k1] += 1
        assert np.all(cover == 1) and len(cta["k_slices"]) * 32 == plan.threads
        assert plan.cols == 4 * 32


def test_plan_at_the_tools_shape():
    """16 CTAs: 8 row groups of 13 rows × 2 slices of 128 columns, K split
    over 8 warps; shared memory: h twice (2 × 13 × 256 floats) and the 8
    warps' 13 × 128 partial tiles (W lives in registers)."""
    assert probes.chain_plan(4) == probes.ChainPlan(16, 8, 2, 13, 128, 8, 256, 79872, 64)
    assert [probes.chain_plan(n).grid for n in CHAINS] == [16, 32, 64]


@pytest.mark.parametrize("n_chains", [0, 5, -1])
def test_plan_raises_outside_the_contract(n_chains):
    with pytest.raises(ValueError, match="n_chains must be"):
        probes.chain_plan(n_chains)


def emulate(xs, ws, n_steps, depth, push=True):
    """The kernel's arithmetic in plain numpy, CTA by CTA: each CTA keeps
    its own two buffers of its rows of h; a dot is each warp's float32
    product over its K slice, the 8 partials summed in K order in float32,
    min(·, 8), written into the CTA's next h and (``push``) into its
    peers'; the result is each CTA's tile of its last h."""
    xs, ws = np.asarray(xs, np.float32), np.asarray(ws, np.float32)
    plan = probes.chain_plan(xs.shape[0])
    ctas = _ctas(plan)
    k_slice = probes.W // plan.k_split
    h = {}
    for cta in ctas:
        r0, r1 = cta["rows"]
        buf = np.zeros((2, plan.rows, probes.W), np.float32)
        buf[0] = xs[cta["chain"], r0:r1]
        h[(cta["chain"], cta["rank"])] = buf
    total = n_steps * depth
    for dot in range(total):
        cur, nxt = dot % 2, (dot + 1) % 2
        new = {}
        for cta in ctas:
            c, (c0, c1) = cta["chain"], cta["cols"]
            a = h[(c, cta["rank"])][cur].reshape(plan.rows, plan.k_split, k_slice)
            b = ws[c, :, c0:c1].reshape(plan.k_split, k_slice, plan.cols)
            parts = np.matmul(a.transpose(1, 0, 2), b).astype(np.float32)
            s = parts[0]
            for p in parts[1:]:
                s = (s + p).astype(np.float32)
            new[(c, cta["rank"])] = np.minimum(s, np.float32(probes.CLAMP))
        for cta in ctas:
            c, (c0, c1) = cta["chain"], cta["cols"]
            for rank in [cta["rank"]] + (cta["peers"] if push else []):
                h[(c, rank)][nxt, :, c0:c1] = new[(c, cta["rank"])]
    out = np.full_like(xs, np.nan)
    for cta in ctas:
        (r0, r1), (c0, c1) = cta["rows"], cta["cols"]
        out[cta["chain"], r0:r1, c0:c1] = h[(cta["chain"], cta["rank"])][total % 2, :, c0:c1]
    return out


@pytest.fixture(scope="module")
def tool_t4():
    spec = importlib.util.spec_from_file_location(
        "_tool_probe_mlp_interleave", os.path.join(REPO, "tools", "probe_mlp_interleave.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool(tool_t4, xs, ws, n_steps):
    n = xs.shape[0]
    shape = jax.ShapeDtypeStruct((probes.ROWS, probes.W), jnp.float32)
    out = pl.pallas_call(tool_t4._chain_kernel(n_steps, n), out_shape=[shape] * n,
                         interpret=True)(*map(jnp.asarray, xs.numpy()),
                                         *map(jnp.asarray, ws.numpy()))
    return np.stack([np.asarray(o) for o in out])


INPUTS = {"tool": (t4.inputs, dict(rtol=1e-6)),
          "random": (t4.check_inputs, dict(rtol=1e-4, atol=1e-5))}


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("n_chains", CHAINS)
def test_emulation_matches_plain_and_the_tool(tool_t4, n_chains, kind):
    """3 steps of the tool's 24 dots."""
    make, tol = INPUTS[kind]
    xs, ws = make(n_chains, "cpu")
    got = emulate(xs, ws, 3, probes.T4_DEPTH)
    assert np.all(np.isfinite(got))
    want = probes.plain_chain_chunk(xs, ws, n_steps=3, depth=probes.T4_DEPTH,
                                    weights_per_depth=False, epilogue="clamp").numpy()
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, _tool(tool_t4, xs, ws, 3), **tol)


@pytest.mark.parametrize("n_chains", CHAINS)
def test_emulation_matches_plain_over_8_random_dots(n_chains):
    """chip_smoke.py phase 26's random case (1 step of 8 dots, values still
    of order 1); without the push the stale columns fail it."""
    xs, ws = t4.check_inputs(n_chains, "cpu")
    want = probes.plain_chain_chunk(xs, ws, n_steps=1, depth=8, weights_per_depth=False,
                                    epilogue="clamp").numpy()
    np.testing.assert_allclose(emulate(xs, ws, 1, 8), want, rtol=1e-4, atol=1e-5)
    unpushed = emulate(xs, ws, 1, 8, push=False)
    assert not np.allclose(unpushed, want, rtol=1e-4, atol=1e-5)
