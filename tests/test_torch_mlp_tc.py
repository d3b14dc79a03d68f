"""The plan the MLP kernel (csrc/mlp_vae.cu) relies on, on the CPU:
kernels/mlp_vae.py's planner mirrors the kernel's cut of every product into
units of 32 rows × 16 columns (one warp's) over a cluster of 8 or 16 CTAs,
the shared memory each CTA stages (the operands and the epilogue's inputs),
and the cluster size a launch takes. The kernel itself runs only on the
card (tests/test_torch_cuda.py).

The shapes are every row the sphere sweep, the sigmoid sweep with
200|200|200 stacks and the dual decoder (sigmoid-MLP) and the linear sweep
with 200|200|200 stacks (linear-MLP) train, at the sweeps' batch of 100,
plus the narrow and ragged stacks the card tests use.
"""

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
    else:  # the card tests' narrow and ragged stacks
        return [((12, 32, 20), (20, 32, 32, 12), False), ((12, 64, 64, 20), (20, 64, 64, 12), False),
                ((21, 7, 13, 200, 16), (16, 7, 13, 200, 21), False),
                ((7, 7, 13, 200, 6), (6, 7, 13, 200, 7), True)]
    return [((D, *hidden, L), (L, *hidden, D), dual) for D, L in dims]


FAMILIES = ["sphere", "sigmoid-MLP", "linear-MLP", "narrow"]


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
