"""The linear kernel's host-side plan (K1, K2, K6a; ``csrc/linear_vae.cu``).

The kernel runs on the card only; what these CPU tests hold is the
arithmetic the host and the kernel share: the shared-memory plan
(``kernels/linear_vae.py:smem_bytes`` mirrors ``plan`` in the .cu file,
buffer by buffer) at every row of the reference's linear and sigmoid
sweeps, the CTA's split into row warps and noise warps, and the
per-parameter pass's tiles (a Python transcription of ``param_pass``'s
numbering): every trained slot of the flat layout is covered by exactly one
tile output, the bias rows are the slots ``matrix_mask`` keeps in f32, and
the loss lane's ε is the one slot left. The card tests
(tests/test_torch_cuda.py) hold the library's own figures to these.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch._scripts.sweep import LINEAR_GRID, SIGMOID_GRID  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402

SOURCE = (Path(k1.__file__).resolve().parent.parent / "csrc" / "linear_vae.cu").read_text()
B = 100  # every sweep's batch
# (D, L, intrinsic, manifold, dual) of every sweep row's shape
SHAPES = ([(dd + pd, ld, dd, dd, False) for dd, pd, ld in LINEAR_GRID]
          + [(dd + 1 + pd, ld, dd, dd, True) for dd, pd, ld in SIGMOID_GRID])
IDS = [f"{'sigmoid' if s[4] else 'linear'}-D{s[0]}-L{s[1]}" for s in SHAPES]


def _constant(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, name
    return m.group(1)


def test_the_cta_split_matches_the_source():
    threads, row_warps, group, team = (
        int(_constant(n)) for n in ("kThreads", "kRowWarps", "kGroup", "kTeam"))
    assert threads == k1.THREADS == 1024
    # the sweeps' batch of 100 rows takes one round of the per-row pass and
    # no more warps than that round needs; the warps left draw the next
    # step's noise
    assert row_warps * 32 // group >= B > (row_warps - 1) * 32 // group
    assert row_warps < threads // 32
    assert team == 8  # a lane of a team updates two of a 4×4 tile's 16 outputs
    for name, value in k1.SKIP.items():
        assert int(_constant(f"kSkip{name.capitalize()}")) == value


def test_smem_bytes_at_linear_row_1_by_hand():
    # the header 128; P = 2·12·20 + 2·20 + 12 + 1 = 533 → 536 a copy, three
    # copies; A 3×3 → 12; e^{ep/2} 20; 4 scalars; 1 − βᵗ of 256 steps 512;
    # the weights' copies WeT 20 × 20, Wd 20 × 12, WdT 12 × 28 (strides odd
    # multiples of 4: D+1 = 13 → 20, D = 12 → 12, L+1 = 21 → 28); x (20 a
    # row), z1, z2 twice: 2·(2000 + 2000 + 1200); n 300; s 2800; g_y 1200;
    # g_mu, g_s·z1 2000 each; the partial sums 300
    floats = (128 + 3 * 536 + 12 + 20 + 4 + 512 + 400 + 240 + 336 + 2 * 5200 + 300
              + 2800 + 1200 + 2 * 2000 + 300)
    assert k1.smem_bytes(B, 12, 20, 3, 3) == 4 * floats == 89040
    for name, value in (("kHeader", k1.HEADER), ("kBcSteps", k1.BC_STEPS)):
        assert int(_constant(name)) == value


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_sweep_row_fits_one_block(shape):
    D, L, id_, dd, dual = shape
    need = k1.smem_bytes(B, D, L, id_, dd, dual)
    assert need <= k1.SMEM_LIMIT
    # the two noise buffers are a real part of it: one step's x, z1 and z2
    noise = 4 * B * ((D + 1 + (D + 1) % 2) + L + D)
    assert need > 2 * noise


def test_the_largest_row_is_the_sigmoid_sweeps_last():
    need = {s: k1.smem_bytes(B, *s[:4], s[4]) for s in SHAPES}
    assert max(need, key=need.get) == (28, 24, 7, 7, True)
    assert need[(28, 24, 7, 7, True)] == 170496  # 73% of a block's 232,448 B


def _tiles(D, L, dual):
    """param_pass's tiles in the kernel's order: for each, the (flat index,
    bf16-eligible) of the outputs its lanes update (lane t of 8: column t % 4,
    rows 2·(t // 4) and 2·(t // 4) + 1)."""
    blocks = [(D + 1, L, 0)]  # [We; be]
    o_wd = D * L + L
    blocks.append((L + 1, D, o_wd))  # [Wd; bd]
    if dual:
        blocks.append((L + 1, D, o_wd + L * D + D + L + 1))  # [Ws; bs]
    tiles = []
    for R, C, off in blocks:
        tc = (C + 3) // 4
        for i in range(((R + 3) // 4) * tc):
            r0, c0 = 4 * (i // tc), 4 * (i % tc)
            tiles.append([(off + r * C + c, r < R - 1) for t in range(8) for h in range(2)
                          for r, c in [(r0 + 2 * (t // 4) + h, c0 + t % 4)] if r < R and c < C])
    o_ep = o_wd + L * D + D
    for c0 in range(0, L, 4):
        tiles.append([(o_ep + c0 + t, False) for t in range(4) if c0 + t < L])
    return tiles


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_the_tiles_cover_every_parameter_once(shape):
    D, L, _, _, dual = shape
    tiles = _tiles(D, L, dual)
    n_tiles = ((D + 4) // 4) * ((L + 3) // 4) + ((L + 4) // 4) * ((D + 3) // 4) * (2 if dual else 1)
    assert len(tiles) == n_tiles + (L + 3) // 4  # the kernel's count
    slots = [i for tile in tiles for i, _ in tile]
    layout = k1.param_layout(D, L, dual)
    o_eps = k1.n_params(D, L) - 1
    assert sorted(slots) == [i for i in range(k1.n_params(D, L, dual)) if i != o_eps]
    # the kernel's bf16 rule (a tile output off its block's last row) is
    # matrix_mask's (the weight matrices, not the biases or ep)
    mask = k1.matrix_mask(layout)
    for i, bf16 in (x for tile in tiles for x in tile):
        assert bool(mask[i]) == bf16, i
    assert not bool(mask[o_eps])


def test_grid_launch_refuses_a_skip_out_of_range():
    p = torch.zeros(k1.n_params(12, 20))
    row = k1.GridRow(12, 20, 3, 3, torch.zeros(3, 3), 0, 0, 1, 2)
    for skip in (-1, sum(k1.SKIP.values()) + 1):
        with pytest.raises(ValueError, match="skip"):
            k1._grid_launch(p, p.clone(), p.clone(), [row], n_steps=1, batch=B, eps_const=-1.0,
                            tdv=True, lr=1e-3, skip=skip)


# --- the bf16-dot mode's plan (csrc/linear_vae.cu plan_bf16, roles) -----------
# Its products run on mma.sync m16n8k16: the per-row pass in 16 × 8 output
# tiles (16 batch rows, the last block masked), the gradient products in
# (m16, n8) tiles over the batch padded to 16 rows, the bias rows and g_ep in
# an f32 pool of teams of 8 lanes; the warps with none of these draw.

def test_bf16_plan_at_linear_row_1_by_hand():
    # the fp32 plan's header, state, A, e^{ep/2}, scalars, 1 − βᵗ: 2252; the
    # bf16 copies (no bias; rows padded to 8, k to 16 + 8): WeT 24 × 24, Wd
    # 24 × 24, WdT 16 × 40 bfloat16 → 288 + 288 + 320 floats; x twice: 112
    # rows of 16 + 4; z1, z2 twice and n as fp32's: 2·(2000 + 1200) + 300;
    # s (bfloat16) 112 × 36 → 2016; g_y 112 × 20; g_mu 112 × 28; g_s·z1
    # 100 × 20; the partials 100 × (3 + 2·2)
    plan = k1.bf16_plan(B, 12, 20)
    assert plan == {"bp": 112, "ldx": 20, "ldg": 20, "ldm": 28, "ldq": 20, "ldwd": 24,
                    "ldwl": 40, "ldal": 36}
    floats = (128 + 3 * 536 + 12 + 20 + 4 + 512 + 288 + 288 + 320 + 2 * 112 * 20
              + 2 * (2000 + 1200) + 300 + 2016 + 112 * 20 + 112 * 28 + 100 * 20 + 100 * 7)
    assert k1.smem_bytes(B, 12, 20, 3, 3, bf16_dots=True) == 4 * floats == 97808
    assert k1.smem_bytes(B, 12, 20, 3, 3) == 89040  # the fp32 plan does not move


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_sweep_row_fits_one_block_in_bf16_mode(shape):
    D, L, id_, dd, dual = shape
    need = k1.smem_bytes(B, D, L, id_, dd, dual, bf16_dots=True)
    assert need <= k1.SMEM_LIMIT
    # the strides the kernel's fragments rely on: zero padding to the k16
    # steps they read, and 4·odd row strides (see the bank tests below)
    plan = k1.bf16_plan(B, D, L)
    kd, kl = -(-D // 16), -(-L // 16)
    assert plan["bp"] == 112 and plan["bp"] >= B
    assert plan["ldx"] >= 16 * kd and plan["ldg"] >= 16 * kd and plan["ldal"] >= 16 * kl
    assert plan["ldwd"] >= 16 * kd + 8 and plan["ldwl"] >= 16 * kl + 8
    assert plan["ldm"] >= -(-L // 8) * 8 and plan["ldq"] >= L
    for name in ("ldx", "ldg", "ldm", "ldal"):
        assert plan[name] % 8 == 4, name
    for name in ("ldwd", "ldwl"):
        assert (plan[name] // 2) % 8 == 4, name  # 32-bit words a row: 4·odd


def test_the_largest_bf16_row_is_the_sigmoid_sweeps_last():
    need = {s: k1.smem_bytes(B, *s[:4], s[4], bf16_dots=True) for s in SHAPES}
    assert max(need, key=need.get) == (28, 24, 7, 7, True)
    assert need[(28, 24, 7, 7, True)] == 182592  # 79% of a block's 232,448 B


def _slot(name, r, c, D, L):
    """Flat index of G[r][c] of a gradient matrix in param_layout's order."""
    o_wd = D * L + L
    return {"We": r * L + c, "Wd": o_wd + r * D + c,
            "Ws": o_wd + L * D + D + L + 1 + r * D + c}[name]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bf16_tiles_cover_every_output_once(shape):
    D, L, _, _, dual = shape
    # the per-row pass: blocks of 16 batch rows × tiles of 8 columns cover
    # every (row, column) of mu and g_mu (L wide) and of y, g_y (D wide) once
    for width in (L, D):
        seen = np.zeros((B, width), int)
        for blk in range(-(-B // 16)):
            for col in range(-(-width // 8)):
                for g in range(8):
                    for u in range(2):
                        for t in range(4):
                            for e in range(2):
                                b, c = 16 * blk + g + 8 * u, 8 * col + 2 * t + e
                                if b < B and c < width:
                                    seen[b, c] += 1
        assert seen.min() == 1 and seen.max() == 1
    # the per-parameter pass: (m16, n8) tiles of g_We (D × L), g_Wd and g_Ws
    # (L × D), each lane's four outputs (rows g, g + 8; columns 2t, 2t + 1)
    tiles = k1.mat_tiles(D, L, dual)
    n_e = -(-D // 16) * -(-L // 8)
    n_w = -(-L // 16) * -(-D // 8)
    assert len(tiles) == n_e + n_w * (2 if dual else 1) <= 22  # ≤ 22 at the largest row
    slots = []
    for name, m0, n0 in tiles:
        rows, cols = (D, L) if name == "We" else (L, D)
        for g in range(8):
            for t in range(4):
                for u in range(2):
                    for e in range(2):
                        r, c = m0 + g + 8 * u, n0 + 2 * t + e
                        if r < rows and c < cols:
                            slots.append(_slot(name, r, c, D, L))
    layout = k1.param_layout(D, L, dual)
    mask = k1.matrix_mask(layout)
    assert sorted(slots) == [i for i in range(k1.n_params(D, L, dual)) if bool(mask[i])]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bf16_bias_rows_and_ep_belong_to_the_f32_pool(shape):
    D, L, _, _, dual = shape
    o_be, o_wd = D * L, D * L + L
    o_bd, o_ep = o_wd + L * D, o_wd + L * D + D
    o_bs = o_ep + L + 1 + L * D
    base = {"be": o_be, "bd": o_bd, "bs": o_bs, "ep": o_ep}
    width = {"be": L, "bd": D, "bs": D, "ep": L}
    pool = [base[name] + c0 + t for name, c0 in k1.pool_tiles(D, L, dual) for t in range(4)
            if c0 + t < width[name]]
    vectors = [base[name] + i for name in (("be", "bd", "bs", "ep") if dual else
                                           ("be", "bd", "ep")) for i in range(width[name])]
    assert sorted(pool) == sorted(vectors)
    # no gradient tile holds a bias or ep slot: they stay off the tensor cores
    mask = k1.matrix_mask(k1.param_layout(D, L, dual))
    assert not any(bool(mask[i]) for i in pool)
    # the pool, the tiles and the loss lane's ε cover the state
    o_eps = o_ep + L
    assert len(pool) + int(mask.sum()) + 1 == k1.n_params(D, L, dual)
    assert o_eps not in pool


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bf16_warp_roles_leave_warps_to_draw(shape):
    D, L, id_, _, dual = shape
    for obs in ((False,) if dual else (False, True)):
        w = k1.warp_roles(B, D, L, id_, dual, obs)
        warps = k1.THREADS // 32
        rows = -(-B // 16) * -(-max(D, L) // 8)  # the largest stage's output tiles
        assert w["rw"] == min(rows, k1.MAX_ROW_WARPS)
        assert w["tw"] == min(len(k1.mat_tiles(D, L, dual)), k1.MAX_TILE_WARPS)
        assert w["pw"] == min(-(-len(k1.pool_tiles(D, L, dual)) // 4), k1.MAX_POOL_WARPS)
        # each phase's warps with rows, tiles or the pool number no more than
        # 32, and the rest (the scalar warp, the last, among them) draw
        assert w["rw"] < warps - 1 and w["tw"] + w["pw"] < warps - 1
        assert warps - w["rw"] >= 8 and warps - w["tw"] - w["pw"] >= 3
        # z2's draws go where the two phases take fewer rounds of calls a lane
        lanes_a, lanes_b = k1.THREADS - 32 * w["rw"], k1.THREADS - 32 * (w["tw"] + w["pw"])
        calls_a = B * (-(-id_ // 4) + (-(-D // 4) if obs else 0) + -(-L // 4))
        calls_z2 = B * -(-D // 4)
        early = -(-(calls_a + calls_z2) // lanes_a)
        late = -(-calls_a // lanes_a) + -(-calls_z2 // lanes_b)
        assert w["z2a"] == (early < late)


def _banks_distinct(words):
    return len({w % 32 for w in set(words)}) == len(set(words))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bf16_fragment_loads_are_free_of_bank_conflicts(shape):
    # lane = 4g + t. B fragments from the weights' bfloat16 copies: one
    # 32-bit word a register, row n0 + g, k = 16·ks + 2t (+ 8): a warp's 32
    # words in 32 banks. The per-parameter pass's pairs (two batch rows of
    # one column): 4-byte loads of the f32 rows (x, g_y, g_u, g_mu) at rows
    # 2t (+ 1) and columns g, and 16-bit loads of R(s) (two lanes may share a
    # word: one wavefront).
    D, L, _, _, _ = shape
    plan = k1.bf16_plan(B, D, L)
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for ld, k16 in ((plan["ldwd"], -(-D // 16)), (plan["ldwl"], -(-L // 16))):
        for ks in range(k16):
            for h in (0, 1):
                words = [(g * ld + 16 * ks + 8 * h + 2 * t) // 2 for g, t in lanes]
                assert _banks_distinct(words), (ld, ks, h)
    for ld in (plan["ldx"], plan["ldg"], plan["ldm"]):
        for e in (0, 1):
            assert _banks_distinct([(2 * t + e) * ld + g for g, t in lanes]), ld
    for e in (0, 1):
        assert _banks_distinct([((2 * t + e) * plan["ldal"] + g) // 2 for g, t in lanes])


def test_bf16_products_run_on_the_tensor_cores():
    # mma.sync bf16 with f32 sums in the bf16-dot passes; no pass rounds its
    # operands on load (dot_op stays only in the manifold draw and A's
    # staging); the roles' limits are the module's
    header = (Path(k1.__file__).resolve().parent.parent / "csrc" / "mma_bf16.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    assert '#include "mma_bf16.cuh"' in SOURCE and SOURCE.count("mma_bf16(") == 1
    assert "dot_op4" not in SOURCE
    assert SOURCE.count("dot_op<kBf16>(") == 3
    for name, value in (("kMaxRowWarps", k1.MAX_ROW_WARPS), ("kMaxTileWarps", k1.MAX_TILE_WARPS),
                        ("kMaxPoolWarps", k1.MAX_POOL_WARPS)):
        assert int(_constant(name)) == value
