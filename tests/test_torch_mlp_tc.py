"""The plan the MLP kernel (csrc/mlp_vae.cu) relies on, on the CPU:
kernels/mlp_vae.py's planner mirrors the kernel's cut of every product into
units of 32 rows × 16 columns (one warp's) over a cluster of 8 or 16 CTAs,
the shared memory each CTA stages (the operands and the epilogue's inputs),
and the cluster size a launch takes. The kernel itself runs only on the
card (tests/test_torch_cuda.py).

The shapes are every row the sphere sweep, the sigmoid sweep with
200|200|200 stacks and the dual decoder (sigmoid-MLP) and the linear sweep
with 200|200|200 stacks (linear-MLP) train, at the sweeps' batch of 100,
plus the narrow and ragged stacks the card tests use, and three 8-layer
stacks that put the bias row of [a_in, 1]ᵀ·G at every row of a unit.

The bf16-dot mode (tensor-core sums) has its own plan: units of 16 rows
where the fp32 mode's are 8, the contraction padded to 16, and strides
that keep mma.sync's fragment loads free of bank conflicts; the tests below
the fp32 mode's pin it. The fp32 plan's numbers do not move.
"""

import ast

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch._scripts import sweep  # noqa: E402
from vae_training_tpu_torch.kernels import mlp_vae as k5  # noqa: E402

B = 100
H = (200, 200, 200)
SRC = k5.__file__.replace("kernels/mlp_vae.py", "csrc/mlp_vae.cu")


def _family(name):
    """(encoder widths, decoder widths, dual) of every row of a family."""
    if name == "sphere":
        dims, dual, hidden = [(dd + pd, ld) for dd, pd, ld in sweep.SPHERE_GRID], False, H
    elif name == "sigmoid-MLP":
        dims, dual, hidden = [(dd + 1 + pd, ld) for dd, pd, ld in sweep.SIGMOID_GRID], True, H
    elif name == "linear-MLP":
        dims, dual, hidden = [(dd + pd, ld) for dd, pd, ld in sweep.LINEAR_GRID], False, H
    elif name == "bias rows":
        return _bias_row_family()
    else:  # the card tests' narrow and ragged stacks
        return [((12, 32, 20), (20, 32, 32, 12), False), ((12, 64, 64, 20), (20, 64, 64, 12), False),
                ((21, 7, 13, 200, 16), (16, 7, 13, 200, 21), False),
                ((7, 7, 13, 200, 6), (6, 7, 13, 200, 7), True)]
    return [((D, *hidden, L), (L, *hidden, D), dual) for D, L in dims]


# (encoder widths, decoder widths) whose layers' [a_in, 1]ᵀ·G products hold
# the bias row (row din) at every row of a 32-row unit (the first two) and of
# a 16-row one (the third) in the bf16-dot plan; chip_smoke.py phase 54 and
# tests/test_torch_cuda.py run them on the card
BIAS_ROW_STACKS = (((32, 33, 34, 35, 36, 37, 38, 39, 30), (30, 40, 41, 42, 43, 44, 45, 46, 32)),
                   ((47, 48, 49, 50, 51, 52, 53, 54, 31), (31, 55, 56, 57, 58, 59, 60, 61, 47)),
                   ((8, 1, 2, 3, 4, 5, 6, 7, 9), (9, 10, 11, 12, 13, 14, 15, 16, 8)))


def _bias_row_family():
    return [(enc, dec, False) for enc, dec in BIAS_ROW_STACKS]


FAMILIES = ["sphere", "sigmoid-MLP", "linear-MLP", "narrow", "bias rows"]


CLUSTERS = (k5.CLUSTER, k5.CLUSTER_WIDE)


def test_tiles_mirror_the_kernel_formula():
    # one sphere product by hand: forward of a 200-wide layer, batch 100
    t = k5.tiles(100, 200, 200, False, False, vecs=1)
    assert (t["m_tiles"], t["n_tiles"], t["qn"], t["mpc"], t["spc"], t["k_pad"], t["kc"]) == (
        4, 13, 8, 4, 2, 200, 200)
    # A: 128 rows × (200 + 4); B: 200 × (32 + 8); the bias's 32 columns; fp32
    assert t["bytes"] == 4 * (128 * 204 + 200 * 40 + 32)
    # on 16 CTAs the rows split in two: 2 m-tiles a CTA
    t = k5.tiles(100, 200, 200, False, False, cluster=16, vecs=1)
    assert (t["qn"], t["mpc"], t["spc"], t["bytes"]) == (8, 2, 2, 4 * (64 * 204 + 200 * 40 + 32))
    # g_W with the bias row: [a_in, 1]ᵀ (201 × 100)·G (100 × 200)
    t = k5.tiles(201, 200, 100, True, False)
    assert (t["m_tiles"], t["kc"], t["bytes"]) == (7, 100, 4 * (100 * 232 + 100 * 40))
    # g_in = G·Wᵀ with the ReLU input's 128 × (32 + 4) slice
    t = k5.tiles(100, 200, 200, False, True, mats=1)
    assert t["bytes"] == 4 * (128 * 204 + 32 * 204 + 128 * 36)
    # strides of 4·odd floats: a contraction of 4·odd pads by 8
    assert k5.tiles(100, 16, 12, False, False)["bytes"] == 4 * (16 * 20 + 12 * 24)
    # a narrow product (the top layers' 6 outputs) spreads its rows over the
    # cluster in units of 8: 13 m-tiles, one or two a CTA
    for cluster, mpc in ((8, 2), (16, 1)):
        t = k5.tiles(100, 6, 200, False, False, cluster=cluster)
        assert (t["tm"], t["m_tiles"], t["qn"], t["mpc"], t["spc"]) == (8, 13, 1, mpc, 1)
    # a stage too large for one chunk is cut into chunks of 4
    t = k5.tiles(100, 2048, 4096, False, True, mats=1)
    assert 4 <= t["kc"] < t["k_pad"] and t["kc"] % 4 == 0
    assert t["bytes"] <= k5.SMEM_MAX - k5.HEADER


@pytest.mark.parametrize("family", FAMILIES)
def test_every_stage_fits_shared_memory(family):
    for enc, dec, dual in _family(family):
        for cluster in CLUSTERS:
            need = k5.smem_bytes(B, enc, dec, dual, cluster)
            assert k5.HEADER < need <= 232448, (enc, dec, dual, cluster, need)
            for p in k5.products(B, enc, dec, dual):
                t = k5.tiles(p.M, p.N, p.K, p.a_t, p.b_t, p.pairs, p.ctas(cluster), p.vecs,
                             p.mats)
                assert t["kc"] == t["k_pad"], (p, t)  # the whole contraction in one stage
        # the wide cluster never stages more
        assert k5.smem_bytes(B, enc, dec, dual, 16) <= k5.smem_bytes(B, enc, dec, dual, 8)


def _covered(p, owners, tm):
    seen = np.zeros((p.M, p.N), np.int32)
    for cta, _, warp, m0, n0 in owners:
        assert 0 <= warp < k5.WARPS and m0 < p.M and n0 < p.N
        seen[m0:m0 + tm, n0:n0 + k5.TILE_N] += 1
    return seen


@pytest.mark.parametrize("family", FAMILIES)
def test_strips_cover_every_output_once(family):
    for enc, dec, dual in _family(family):
        for p in k5.products(B, enc, dec, dual):
            for cluster in CLUSTERS:
                owners = k5.unit_owners(p, cluster)
                assert all(0 <= o[0] < p.ctas(cluster) for o in owners)
                assert p.half == (dual and p.phase.startswith("dec") and p.pairs == 1
                                  and p.phase not in ("dec g_s",) and p.mats != 2)
                tm = k5.tiles(p.M, p.N, p.K, p.a_t, p.b_t, p.pairs, p.ctas(cluster))["tm"]
                assert tm == (8 if min(p.M, p.N) <= 16 else 32)  # narrow products: 8 rows
                seen = _covered(p, owners, tm)
                assert seen.min() == 1 and seen.max() == 1, (p, enc, cluster)
                assert len(set(o[3:] for o in owners)) == len(owners)
                # one unit a warp a round: no two units share a (cta, round, warp)
                assert len(set(o[:3] for o in owners)) == len(owners)


def test_a_sphere_layers_units_take_one_round():
    # a 200-wide layer's forward at batch 100: 4 × 2 units a CTA of 8, 2 × 2
    # of 16; [a_in, 1]ᵀ·G's 201 rows: 7 × 2 a CTA of 8, within 16 warps
    fwd = k5.Product("enc fwd 1", 100, 200, 200, False, False, 1, 1, 0)
    g_w = k5.Product("enc g_W 1", 201, 200, 100, True, False)
    for p, cluster, most in ((fwd, 8, 8), (fwd, 16, 4), (g_w, 8, 14), (g_w, 16, 8)):
        owners = k5.unit_owners(p, cluster)
        per_cta = [sum(o[0] == q for o in owners) for q in range(cluster)]
        assert max(per_cta) == most and {o[1] for o in owners} == {0}


@pytest.mark.parametrize("n_rows", [1, 3, 15, 20])
def test_a_rows_plan_does_not_depend_on_the_launch(n_rows):
    # K6b's rows: the sphere sweep's 15 runs (5 dims × 3 seeds), repeated
    rows = [r for r in _family("sphere") for _ in range(3)]
    rows = (rows * 2)[:n_rows]
    most = {8: 15, 16: 7}  # clusters an H100's 132 SMs hold at once, as an example
    size = k5.cluster_size(n_rows, most)
    assert size == (16 if n_rows <= 7 else 8)  # the wide cluster where it adds no turn
    solo = {(enc, dec): [k5.unit_owners(p, size) for p in k5.products(B, enc, dec)]
            for enc, dec, _ in rows}
    plan = k5.cluster_plan(n_rows, most[size])
    clusters = min(n_rows, most[size])
    assert sorted(set(c for c, _ in plan)) == list(range(clusters))
    for i, (cluster, turn) in enumerate(plan):
        assert (cluster, turn) == (i % clusters, i // clusters)
        enc, dec, _ = rows[i]
        assert [k5.unit_owners(p, size) for p in k5.products(B, enc, dec)] == solo[(enc, dec)]


def test_the_wide_cluster_is_taken_only_where_it_adds_no_turn():
    assert k5.cluster_size(1, {8: 15, 16: 0}) == 8  # a card that holds no cluster of 16
    assert k5.cluster_size(8, {8: 15, 16: 8}) == 16
    assert k5.cluster_size(9, {8: 15, 16: 8}) == 8
    assert k5.cluster_size(30, {8: 15, 16: 8}) == 8
    assert k5.cluster_size(300, {8: 15, 16: 15}) == 16  # equal turns: the wider


def test_the_kernel_is_a_cluster_launch():
    src = open(SRC).read()
    for absent in ("this_grid", "grid.sync", "cudaLaunchCooperativeKernel"):
        assert absent not in src
    for present in ("cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension",
                    "cudaFuncAttributeNonPortableClusterSizeAllowed", "cluster.sync()"):
        assert present in src
    # the Python mirror's constants are the kernel's
    for name, value in (("kCluster", k5.CLUSTER), ("kClusterWide", k5.CLUSTER_WIDE),
                        ("kThreads", k5.THREADS), ("kTileM", k5.TILE_M), ("kTileN", k5.TILE_N),
                        ("kKStep", k5.KSTEP),
                        ("kSmemMax", k5.SMEM_MAX), ("kHeader", k5.HEADER),
                        ("kMaxRows", k5.MAX_ROWS)):
        assert f"constexpr int {name} = {value};" in src


# --- the bf16-dot mode's plan: tensor-core sums (mma.sync m16n8k16) ------------
# A warp's unit is 2 × 2 tiles of 16 × 8 (a narrow unit 1 × 2), each lane
# holding fragment pairs along k: the contraction pads to 16, a narrow unit
# is 16 rows high, and the stage's strides keep the fragments' loads free of
# bank conflicts.

def test_bf16_tiles_by_hand():
    # forward of a 200-wide layer at batch 100: fp32's cut, the contraction
    # padded to 208; A [m][k] rows of 208 + 8 (8·odd), B [k][n] rows of 32 + 4
    t = k5.tiles(100, 200, 200, False, False, vecs=1, bf16_dots=True)
    assert (t["m_tiles"], t["n_tiles"], t["qn"], t["mpc"], t["spc"], t["k_pad"], t["kc"],
            t["sa"], t["sb"]) == (4, 13, 8, 4, 2, 208, 208, 216, 36)
    assert t["bytes"] == 4 * (128 * 216 + 208 * 36 + 32)
    # g_W with the bias row: batch 100 padded to 112, A [k][m] rows of 224 + 4
    t = k5.tiles(201, 200, 100, True, False, bf16_dots=True)
    assert (t["m_tiles"], t["k_pad"], t["sa"], t["bytes"]) == (7, 112, 228,
                                                                4 * (112 * 228 + 112 * 36))
    # g_in = G·Wᵀ: both operands [·][k], rows of 208 + 8
    t = k5.tiles(100, 200, 200, False, True, mats=1, bf16_dots=True)
    assert (t["sa"], t["sb"]) == (216, 216)
    assert t["bytes"] == 4 * (128 * 216 + 32 * 216 + 128 * 36)
    # a narrow product in units of one 16-row tile: the top layers' 6
    # outputs in 7 m-tiles, one a CTA; the first layer's g_W, 7 rows
    for cluster in CLUSTERS:
        t = k5.tiles(100, 6, 200, False, False, cluster=cluster, bf16_dots=True)
        assert (t["tm"], t["m_tiles"], t["qn"], t["mpc"], t["spc"]) == (16, 7, 1, 1, 1)
    t = k5.tiles(7, 200, 100, True, False, bf16_dots=True)
    assert (t["tm"], t["m_tiles"], t["sa"]) == (16, 1, 20)
    # a stage too large for one chunk is cut into chunks of 16
    t = k5.tiles(100, 2048, 4096, False, True, mats=1, bf16_dots=True)
    assert 16 <= t["kc"] < t["k_pad"] and t["kc"] % 16 == 0
    assert t["bytes"] <= k5.SMEM_MAX - k5.HEADER


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_stages_fit_shared_memory(family, cluster):
    for enc, dec, dual in _family(family):
        need = k5.smem_bytes(B, enc, dec, dual, cluster, bf16_dots=True)
        assert k5.HEADER < need <= 232448, (enc, dec, dual, cluster, need)
        for p in k5.products(B, enc, dec, dual):
            t = k5.tiles(p.M, p.N, p.K, p.a_t, p.b_t, p.pairs, p.ctas(cluster), p.vecs, p.mats,
                         bf16_dots=True)
            assert t["kc"] == t["k_pad"], (p, t)  # the whole contraction in one stage
        # the wide cluster never stages more
        assert (k5.smem_bytes(B, enc, dec, dual, 16, bf16_dots=True)
                <= k5.smem_bytes(B, enc, dec, dual, 8, bf16_dots=True))


@pytest.mark.parametrize("K", [6, 7, 13, 16, 21, 100, 200, 201])
def test_bf16_contraction_pads_to_16(K):
    # the mma's k16 steps read exact zeros past K; every chunk is whole k16
    # steps, so an output's sum runs over the same steps whatever kc is
    for a_t, b_t in ((False, False), (True, False), (False, True)):
        for cluster in CLUSTERS:
            t = k5.tiles(100, 200, K, a_t, b_t, cluster=cluster, bf16_dots=True)
            assert t["k_pad"] % 16 == 0 and 0 <= t["k_pad"] - K < 16
            assert t["kc"] % 16 == 0 and t["kc"] == t["k_pad"]
            # the fp32 plan pads to 4, as before
            f = k5.tiles(100, 200, K, a_t, b_t, cluster=cluster)
            assert f["k_pad"] % 4 == 0 and 0 <= f["k_pad"] - K < 4


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_units_cover_every_output_once(family):
    for enc, dec, dual in _family(family):
        for p in k5.products(B, enc, dec, dual):
            for cluster in CLUSTERS:
                owners = k5.unit_owners(p, cluster, bf16_dots=True)
                assert all(0 <= o[0] < p.ctas(cluster) for o in owners)
                tm = k5.tiles(p.M, p.N, p.K, p.a_t, p.b_t, p.pairs, p.ctas(cluster),
                              bf16_dots=True)["tm"]
                assert tm == (16 if min(p.M, p.N) <= 16 else 32)  # narrow: one mma tile high
                seen = _covered(p, owners, tm)
                assert seen.min() == 1 and seen.max() == 1, (p, enc, cluster)
                assert len(set(o[:3] for o in owners)) == len(owners)
                # the wide products' cut is the fp32 mode's
                if tm == 32:
                    assert owners == k5.unit_owners(p, cluster)


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_bias_row_has_one_owner(family):
    # g_b, the last row of [a_in, 1]ᵀ·G, is summed apart from the mma, from
    # the unrounded G, by the lanes that hold that row: in each n-tile one
    # warp's unit holds it, at the same row of the same unit (so the same
    # lanes, g = row % 8, and the same tile) on either cluster size
    for enc, dec, dual in _family(family):
        for p in k5.products(B, enc, dec, dual):
            if not p.a_t:
                continue
            where = {}
            for cluster in CLUSTERS:
                tm = k5.tiles(p.M, p.N, p.K, p.a_t, p.b_t, p.pairs, p.ctas(cluster),
                              bf16_dots=True)["tm"]
                holders = {}
                for cta, rnd, warp, m0, n0 in k5.unit_owners(p, cluster, bf16_dots=True):
                    if m0 <= p.M - 1 < m0 + tm:
                        holders.setdefault(n0, []).append((cta, rnd, warp))
                assert sorted(holders) == list(range(0, p.N, k5.TILE_N)), (p, cluster)
                assert all(len(h) == 1 for h in holders.values()), (p, cluster)
                row = (p.M - 1) % tm  # in its unit
                where[cluster] = (tm, row // 16, (row % 16) // 8, row % 8)
            assert where[k5.CLUSTER] == where[k5.CLUSTER_WIDE], (p, where)


def _banks_distinct(words):
    """Whether one shared-memory wavefront's 4-byte words fall in distinct
    banks (32 banks of 4 bytes)."""
    return len({w % 32 for w in words}) == len(words)


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_fragment_loads_are_free_of_bank_conflicts(family):
    # one k16 step of a unit at the stage's origin, lane = 4g + t: A's pairs
    # at rows g, g + 8 (+ 16 mi) and k = 2t, 2t + 8; B's at columns g (+ 8 ni)
    # and the same k. Along k ([m][k], [n][k]) a pair is one 8-byte load,
    # served a half-warp at a time; across rows ([k][m], [k][n]) two 4-byte
    # loads, a warp at a time.
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for enc, dec, dual in _family(family):
        for p in k5.products(B, enc, dec, dual):
            for cluster in CLUSTERS:
                t = k5.tiles(p.M, p.N, p.K, p.a_t, p.b_t, p.pairs, p.ctas(cluster), p.vecs,
                             p.mats, bf16_dots=True)
                loads = []  # (along k?, stride, {lane: (row or column, k)})
                for mi in range(t["tm"] // 16):
                    for h in (0, 1):
                        for u in (0, 1):
                            loads.append((not p.a_t, t["sa"],
                                          [(16 * mi + 8 * u + g, 8 * h + 2 * q) for g, q in lanes]))
                for ni in (0, 1):
                    for h in (0, 1):
                        loads.append((p.b_t, t["sb"], [(8 * ni + g, 8 * h + 2 * q)
                                                       for g, q in lanes]))
                for along_k, stride, at in loads:
                    if along_k:  # 8-byte loads: row·stride + k, two words each
                        for half in (at[:16], at[16:]):
                            words = [r * stride + k + e for r, k in half for e in (0, 1)]
                            assert _banks_distinct(words), (p, cluster, stride)
                    else:  # 4-byte loads: k·stride + row, at k and at k + 1
                        for e in (0, 1):
                            words = [(k + e) * stride + r for r, k in at]
                            assert _banks_distinct(words), (p, cluster, stride)


def test_bf16_bias_row_stacks_reach_every_row_of_a_unit():
    # the stacks that chip_smoke.py phase 54 holds on the card put g_b's row
    # at each of a 32-row unit's rows and of a 16-row unit's
    seen = set()
    for enc, dec, dual in _family("bias rows"):
        for p in k5.products(B, enc, dec, dual):
            if p.a_t:
                tm = k5.tiles(p.M, p.N, p.K, True, False, bf16_dots=True)["tm"]
                seen.add((tm, (p.M - 1) % tm))
    assert seen == {(32, r) for r in range(32)} | {(16, r) for r in range(16)}
    # chip_smoke.py (which imports no test) holds the same stacks
    smoke = ast.parse(open(SRC.replace("vae_training_tpu_torch/csrc/mlp_vae.cu",
                                       "chip_smoke.py")).read())
    (value,) = [node.value for node in smoke.body if isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets] == ["BIAS_ROW_STACKS"]]
    assert ast.literal_eval(value) == BIAS_ROW_STACKS


def test_bf16_products_run_on_the_tensor_cores():
    src = open(SRC).read()
    for name, value in (("kTileMNarrowBf16", k5.TILE_M_NARROW_BF16),
                        ("kKStepBf16", k5.KSTEP_BF16)):
        assert f"constexpr int {name} = {value};" in src
    # the product itself: the shared tensor-core header the kernel includes
    assert '#include "mma_bf16.cuh"' in src and "mma_bf16(" in src
    header = open(SRC.replace("mlp_vae.cu", "mma_bf16.cuh")).read()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    # the fp32 sums round nothing: the operands' rounding lives in tc_sums
    # (fragments) and in the manifold draws alone
    sums = src[src.index("struct LaneBlock"):src.index("// A warp's bf16-dot sums over")]
    assert "dot_op" not in sums and "kBf16" not in sums and "bf16" not in sums
    assert src.count("dot_op<kBf16>(") == 4  # the sigmoid's and the linear draw's operands
