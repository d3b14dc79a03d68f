"""The phase form's fp32 cut (csrc/probes.cu phase_dot_fp32), mirrored as
plain index arithmetic in kernels/probes.py, checked on the CPU.

A dot is cut into units of 16 rows × 16 columns of one chain
(``phase_units(..., bf16_dots=False)``), four to a 512-thread CTA a round,
each unit's K split over 8 half-warps of 32 k (``phase_fp32_lane``): a
half-warp stages its h and W slices by 16 cp.async copies a lane
(``phase_fp32_copies``), its lanes keep 4 × 4 outputs as fmaf chains over
the slice in ascending k, and 64 threads of the unit add the 8 partial
tiles in rank order (``phase_fp32_sum_row``). Checked here:

  - (tests/test_torch_probe_layouts.py checks, in both dot modes, that
    the units own every output once and that their order does not depend
    on the chain count)
  - over a unit's half-warps and lanes every output takes every k once;
    the copies stage each half-warp's slices once (h's rows past 103 not
    at all); the sum threads cover the unit once;
  - under the 32-bank model (``smem_wavefronts``) every shared-memory access
    of the body takes the least wavefronts;
  - a numpy emulation of the kernel's order (each K slice's 32-long fmaf
    chain from zero, each fmaf taken in float64 and rounded to float32, then
    the 8 slices added in rank order in float32) run through the tool's
    chains equals ``plain_chain_chunk`` and the JAX tool's ``_chain_kernel``
    (interpret mode, the tool loaded by file path) at ``chip_smoke.py`` phase
    26's tolerances: rtol 1e-6 on the tool's inputs (diagonal weights: one
    nonzero term an output), rtol 1e-4 / atol 1e-5 on ``check_inputs``;
    an emulation that drops a K slice fails that.

Inputs come from numpy seeds.
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
R, W = probes.ROWS, probes.W
COLS, SLOTS = probes.PHASE_COLS_FP32, probes.PHASE_SLOTS_FP32
K_SPLIT = probes.PHASE_K_SPLIT
LANES = np.arange(32)
SMEM_LIMIT = 232448


# --- the cut -------------------------------------------------------------------

@pytest.mark.parametrize("slot", range(SLOTS))
def test_phase_fp32_lanes_cover_each_outputs_k_once(slot):
    """The unit of slot ``slot`` is its 4 warps: over their 8 half-warps (the
    ranks kq 0..7, once each) and lanes, every (row, column, k) once."""
    seen = np.zeros((16, COLS, W), int)
    ranks = []
    for warp in range(SLOTS * slot, SLOTS * slot + 4):
        for lane in range(32):
            ln = probes.phase_fp32_lane(warp, lane)
            assert ln["slot"] == slot
            k0, k1 = ln["k"]
            for r in ln["rows"]:
                for c in ln["cols"]:
                    seen[r, c, k0:k1] += 1
            ranks.append(ln["kq"])
    assert np.all(seen == 1)
    assert sorted(set(ranks)) == list(range(K_SPLIT)) and len(ranks) == 16 * K_SPLIT


@pytest.mark.parametrize("mt", [0, probes.PHASE_M_TILES - 1])
def test_phase_fp32_copies_stage_each_slice_once(mt):
    """A half-warp's 16 lanes × 16 copies of 16 bytes: h's 16 rows × 32 k of
    the slice (rows past 103 not copied) and W's 32 k × 16 columns, each
    float once, at distinct 16-byte places of its stage."""
    h_seen, w_seen, places = np.zeros((16, 32), int), np.zeros((32, COLS), int), []
    for l in range(16):
        for kind, a, b, off in probes.phase_fp32_copies(l):
            places.append(off)
            if kind == "h":
                if 16 * mt + a < R:
                    h_seen[a, 4 * b:4 * b + 4] += 1
            else:
                w_seen[a, 4 * b:4 * b + 4] += 1
    live = (16 * mt + np.arange(16)) < R
    assert np.all(h_seen[live] == 1) and np.all(h_seen[~live] == 0)
    assert np.all(w_seen == 1)
    assert len(set(places)) == len(places) == 256 and all(o % 4 == 0 for o in places)
    assert max(places) + 4 <= probes.PHASE_STAGE_FP32
    assert probes.PHASE_SMEM_FP32 == 139264 and probes.PHASE_SMEM_FP32 + 4 * R * 8 <= SMEM_LIMIT


def test_phase_fp32_sum_threads_cover_the_unit_once():
    i = np.arange(64)
    rows, cols = probes.phase_fp32_sum_row(i)
    seen = np.zeros((16, COLS), int)
    for r, c in zip(rows, cols):
        seen[r, c:c + 4] += 1
    assert np.all(seen == 1)


def _fp32_instructions():
    """(kind, byte addresses of the 32 lanes, bytes a lane) of every lane
    instruction of one warp (warp 0: ranks 0 and 1) of a unit's dot."""
    out = []
    ln = probes.phase_fp32_lane(0, LANES)
    base = 4 * probes.PHASE_STAGE_FP32 * ln["kq"]  # bytes: each half-warp's stage
    for k in range(0, 32, 4):
        for o in ln["a"](k):
            out.append(("a", list(base + 4 * o), 16))
        for o in ln["b"](k):
            out.append(("b", list(base + 4 * o), 16))
    for o in ln["part"]:
        out.append(("part", list(base + 4 * o), 16))
    copies = [probes.phase_fp32_copies(LANES % 16)[j][3] for j in range(16)]
    for o in copies:
        out.append(("copies", list(base + 4 * o), 16))
    rows, cols = probes.phase_fp32_sum_row(LANES)  # the unit's first sum warp
    for q in range(K_SPLIT):
        o = 4 * (q * probes.PHASE_STAGE_FP32 + rows * probes.PHASE_PART_STRIDE_FP32 + cols)
        out.append(("sums", list(o), 16))
    return out


@pytest.mark.parametrize("kind", ["a", "b", "part", "copies", "sums"])
def test_phase_fp32_smem_accesses_take_the_least_wavefronts(kind):
    got = [(probes.smem_wavefronts(a, w), probes.least_wavefronts(a, w))
           for k, a, w in _fp32_instructions() if k == kind]
    assert got and all(n == least for n, least in got)


# --- the summation order, emulated -------------------------------------------

def emulate(xs, ws, n_steps, depth, drop=None):
    """The kernel's order of one T4 chain chunk in numpy: each K slice's
    fmaf chain over its 32 k (from ``phase_fp32_lane``) from zero, each fmaf
    taken in float64 and rounded to float32, the 8 slices added in rank
    order in float32, min(·, 8); ``drop`` leaves out that slice."""
    h = np.asarray(xs, np.float32)
    w = np.asarray(ws, np.float64)
    slices = sorted({probes.phase_fp32_lane(warp, lane)["k"] for warp in range(4)
                     for lane in range(32)})
    for _ in range(n_steps * depth):
        hd = h.astype(np.float64)
        parts = np.zeros((len(slices),) + h.shape, np.float32)
        for kl in range(32):
            ks = [k0 + kl for k0, _ in slices]
            prod = (hd[:, :, ks].transpose(2, 0, 1)[..., None]
                    * w[:, ks, :].transpose(1, 0, 2)[:, :, None])
            parts = (prod + parts).astype(np.float32)
        y = parts[0].copy()
        for q in range(1, len(slices)):
            if q != drop:
                y = (y + parts[q]).astype(np.float32)
        h = np.minimum(y, np.float32(probes.CLAMP))
    return h


@pytest.fixture(scope="module")
def tool_t4():
    spec = importlib.util.spec_from_file_location(
        "_tool_probe_mlp_interleave_phase", os.path.join(REPO, "tools", "probe_mlp_interleave.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool(tool_t4, xs, ws, n_steps):
    n = xs.shape[0]
    shape = jax.ShapeDtypeStruct((R, W), jnp.float32)
    out = pl.pallas_call(tool_t4._chain_kernel(n_steps, n), out_shape=[shape] * n,
                         interpret=True)(*map(jnp.asarray, xs.numpy()),
                                         *map(jnp.asarray, ws.numpy()))
    return np.stack([np.asarray(o) for o in out])


INPUTS = {"tool": (t4.inputs, dict(rtol=1e-6)),
          "random": (t4.check_inputs, dict(rtol=1e-4, atol=1e-5))}


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("n_chains", [1, 2, 4])
def test_phase_fp32_emulation_matches_plain_and_the_tool(tool_t4, n_chains, kind):
    """One step of the tool's 24 dots."""
    make, tol = INPUTS[kind]
    xs, ws = make(n_chains, "cpu")
    got = emulate(xs.numpy(), ws.numpy(), 1, probes.T4_DEPTH)
    assert np.all(np.isfinite(got))
    want = probes.plain_chain_chunk(xs, ws, n_steps=1, depth=probes.T4_DEPTH,
                                    weights_per_depth=False, epilogue="clamp").numpy()
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, _tool(tool_t4, xs, ws, 1), **tol)


@pytest.mark.parametrize("n_chains", [1, 4])
def test_phase_fp32_emulation_matches_plain_over_8_random_dots(n_chains):
    """chip_smoke.py phase 26's random case (8 dots, values still of order
    1); without one K slice the sums fail it."""
    xs, ws = t4.check_inputs(n_chains, "cpu")
    want = probes.plain_chain_chunk(xs, ws, n_steps=1, depth=8, weights_per_depth=False,
                                    epilogue="clamp").numpy()
    np.testing.assert_allclose(emulate(xs.numpy(), ws.numpy(), 1, 8), want, rtol=1e-4, atol=1e-5)
    dropped = emulate(xs.numpy(), ws.numpy(), 1, 8, drop=3)
    assert not np.allclose(dropped, want, rtol=1e-4, atol=1e-5)
