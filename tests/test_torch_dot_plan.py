"""T2's dot kernel (csrc/probes.cu dot_kernel) planned on the CPU.

``kernels/probes.py:dot_plan`` is the same integer arithmetic as the
library's ``dot_plan`` (held equal on the card, tests/test_torch_cuda.py),
and ``dot_block`` the kernel's index arithmetic for one CTA. Over a grid of
shapes the contract admits (M a multiple of 16 up to 256, K of 16 up to
512, N of 8 up to 512), in every mode: every output element lies in exactly
one tile, each tile's K is cut into slices that cover it once, each
cluster rank sums a disjoint band of the tile's rows, the cluster is at
most 8 CTAs and a CTA's shared memory at most 232,448 bytes. A plain
emulation of the kernel's order of sums (each slice's product in float32,
the slices summed in rank order in float32) matches JAX's ``jnp.dot`` at
the tool's shape and two small ones, at
``test_t2_fp32_and_bf16_modes_match_jax``'s tolerance (rtol 1e-5, atol
1e-4): ``precision=HIGHEST`` for fp32, bf16-cast operands for bf16, and
float64 sums of TF32-rounded operands for TF32. Inputs come from numpy
seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch.kernels import probes  # noqa: E402

MS = (16, 48, 64, 112, 128, 256)
KS = (16, 32, 48, 112, 256, 272, 512)
NS = (8, 24, 32, 40, 136, 256, 512)


def _blocks(plan, M, K, N):
    return [probes.dot_block(plan, M, K, N, bx, by)
            for by in range(plan.grid_y) for bx in range(plan.grid_x)]


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("mode", sorted(probes.MODES))
def test_plan_covers_every_output_once(mode, M):
    for K in KS:
        for N in NS:
            plan = probes.dot_plan(M, K, N, mode)
            where = f"{(M, K, N)} {mode}: {plan}"
            assert plan.cluster == plan.split and plan.split in (1, 2, 4, 8), where
            assert plan.cluster <= 8 and plan.grid_x % plan.cluster == 0, where
            assert plan.smem <= probes.DOT_MAX_SMEM, where
            assert plan.split == 1 or plan.grid_x * plan.grid_y <= probes.DOT_MAX_BLOCKS, where
            assert plan.threads == 128 and (plan.tile_m, plan.tile_n) == (64, 32), where
            cover = np.zeros((M, N), np.int64)
            tiles = {}
            for b in _blocks(plan, M, K, N):
                tiles.setdefault((b["rows"], b["cols"]), []).append(b)
            for (rows, cols), members in tiles.items():
                assert sorted(b["rank"] for b in members) == list(range(plan.split)), where
                cover[rows[0]:rows[1], cols[0]:cols[1]] += 1
                # the slices, in rank order, cover [0, K) once, whole units of 16
                ks = [b["k"] for b in sorted(members, key=lambda b: b["rank"])]
                assert ks[0][0] == 0 and ks[-1][1] == K, where
                assert all(a[1] == b[0] for a, b in zip(ks, ks[1:])), where
                assert all(k1 > k0 and (k1 - k0) % 16 == 0 for k0, k1 in ks), where
                # the ranks' bands of summed rows cover the tile's live rows once
                band = np.zeros(M, np.int64)
                for b in members:
                    band[b["sums_rows"][0]:b["sums_rows"][1]] += 1
                assert np.all(band[rows[0]:rows[1]] == 1) and band.sum() == rows[1] - rows[0], where
            assert np.all(cover == 1), where


def test_plan_at_the_tools_shape():
    """(128, 256, 256): 16 tiles, K split 8 ways (32 each), 128 CTAs in
    clusters of 8; shared memory by mode."""
    for mode, smem in (("fp32", 23552), ("tf32", 35840), ("bf16", 29696)):
        plan = probes.dot_plan(128, 256, 256, mode)
        assert dataclasses.astuple(plan) == (64, 32, 32, 8, 8, 64, 2, smem, 128)
        assert [probes.dot_slice(256, 8, q) for q in range(8)] == [(32 * q, 32 * q + 32)
                                                                    for q in range(8)]


def test_uneven_slices_are_whole_units():
    """K 272 is 17 units of 16: over 8 ranks, the first gets 3 units."""
    assert [probes.dot_slice(272, 8, q) for q in range(8)] == [
        (0, 48), (48, 80), (80, 112), (112, 144), (144, 176), (176, 208), (208, 240), (240, 272)]
    assert probes.dot_plan(16, 16, 8, "bf16").split == 1  # one unit: no split
    assert probes.dot_plan(256, 512, 512, "fp32").split == 2  # 64 tiles: 128 CTAs


@pytest.mark.parametrize("shape, match", [
    ((15, 16, 8), "multiple of 16"), ((16, 16, 12), "multiple of 16"),
    ((16, 24, 8), "multiple of 16"), ((0, 16, 8), "multiple of 16"),
    ((16, 16, 0), "multiple of 16"), ((64 * 65536, 16, 8), "grid")])
def test_plan_raises_outside_the_contract(shape, match):
    with pytest.raises(ValueError, match=match):
        probes.dot_plan(*shape, "fp32")


def test_plan_raises_on_an_unknown_mode():
    with pytest.raises(ValueError, match="mode must be"):
        probes.dot_plan(16, 16, 8, "fp16")


def _round(a, mode):
    if mode == "tf32":
        return probes.round_tf32(torch.as_tensor(a)).numpy()
    if mode == "bf16":
        return torch.as_tensor(a).bfloat16().float().numpy()
    return a


def emulate(x, w, mode):
    """The kernel's sums in plain numpy: each CTA's slice product in
    float32, the cluster's slices summed in rank order in float32."""
    M, K = x.shape
    N = w.shape[1]
    plan = probes.dot_plan(M, K, N, mode)
    xr, wr = _round(x, mode), _round(w, mode)
    out = np.full((M, N), np.nan, np.float32)
    for b in _blocks(plan, M, K, N):
        if b["rank"]:
            continue
        (r0, r1), (c0, c1) = b["rows"], b["cols"]
        acc = None
        for q in range(plan.split):
            k0, k1 = probes.dot_slice(K, plan.split, q)
            part = np.matmul(xr[r0:r1, k0:k1], wr[k0:k1, c0:c1]).astype(np.float32)
            acc = part if acc is None else (acc + part).astype(np.float32)
        out[r0:r1, c0:c1] = acc
    return out


@pytest.mark.parametrize("shape", [(128, 256, 256), (48, 32, 24), (112, 272, 40)],
                         ids=["tool", "48x32x24", "112x272x40"])
def test_split_k_order_matches_jax(shape):
    M, K, N = shape
    x = np.random.RandomState(M + K).randn(M, K).astype(np.float32)
    w = np.random.RandomState(K + N).randn(K, N).astype(np.float32)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    highest = np.asarray(jnp.dot(jx, jw, precision=jax.lax.Precision.HIGHEST,
                                 preferred_element_type=jnp.float32))
    cast = np.asarray(jnp.dot(jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    tf32 = _round(x, "tf32").astype(np.float64) @ _round(w, "tf32").astype(np.float64)
    for mode, want in (("fp32", highest), ("bf16", cast), ("tf32", tf32)):
        got = emulate(x, w, mode)
        assert np.all(np.isfinite(got)), mode
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4, err_msg=mode)


def test_launch_refuses_operands_off_a_16_byte_boundary():
    """The kernel copies 16 bytes at a time: a view that starts 4 bytes in
    is refused before any launch."""
    x = torch.zeros(16 * 16 + 1)[1:].view(16, 16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        probes._dot_launch(x, torch.zeros(16, 8), "fp32")
