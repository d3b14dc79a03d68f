"""The bf16 phase and stream forms' cuts and shared-memory layouts
(csrc/probes.cu), mirrored as plain index arithmetic in kernels/probes.py,
checked on the CPU.

The stream form (``chain_stream_kernel<·, bf16>``) streams a bf16 copy of
its weights, a CTA's dot in one 3-D TMA copy, into ring slots that the copy
swizzles 128 B (``stream_slot_offset``: 16-byte chunk j of line k at chunk
j ^ (k mod 8)) and reads its B values 16 bytes at a time under a column
permutation (n8 tile 8p + r's column j is the slice's column 64p + 8j + r;
``stream_b_offset``),
its A pairs from h rows padded to 264 floats (``stream_a_offset``), and
stores its partial tiles as float4 into rows padded to 132 with swizzled
chunks (``stream_part_offset``, ``stream_store_col``). The phase form
(``chain_phase_kernel<bf16>``) cuts a dot into units of 16 rows × 32
columns whose K is split over 8 warps (``phase_units``), each warp's
operands float4 from L2 in a K order permuted within each k16 step
(``phase_lane_loads``), its partial tile stored into rows of 36
(``phase_part_offset``). Checked here:

  - each mapping is a bijection onto its stage, tile or slice;
  - under a 32-bank model (``smem_wavefronts``: phases of 128 / width
    lanes, one 4-byte word a bank a wavefront) every lane-read and
    lane-write instruction of the bf16 products takes the least number of
    wavefronts (1 a phase with an active lane: 1 for 4 bytes a lane, 2 for
    float2, 4 for float4), and the earlier bodies' layouts, which did not, fail it;
  - the phase form's cut owns every output of every chain once and covers
    each output's k once, and a unit's arithmetic does not depend on the
    chain count (only which CTA and round run it does);
  - one bf16 dot emulated in numpy through the mirrored addresses (each
    mma.sync m16n8k16 from the fragment registers the lanes load, its 16
    exact products summed and rounded once to f32; the k16 partials added
    in f32 in ascending k, the partial tiles in rank order) equals
    ``plain_chain_chunk(..., bf16_dots=True)`` bitwise on two-term inputs
    and is within ρ ≤ 1e-3 of it on dense ones, with the fp32 plain
    version as the yardstick of ρ.

The cluster form's bf16 cut (``chain_cluster_kernel<bf16>``) splits N over
its warps (``cluster_lane``: warp w's 16 columns, two n8 tiles, over the
whole K; W's slice as B pairs in registers) and keeps h as bf16 in 16-row
buffers whose 16-byte chunks are permuted by the row (``cluster_h_offset``),
read by ldmatrix; checked: the lanes cover each CTA's 13 × 128 outputs and
each warp's W slice once, the layout is a bijection, its ldmatrix reads and
8-byte epilogue stores take the least wavefronts (unswizzled rows of 256
do not), and one bf16 dot through the mirrored addresses (16 k16 partials
a lane from zero, added in ascending k) equals the plain version bitwise on
two-term inputs and within ρ ≤ 1e-3 on dense ones.

Also the splits' timing order (``tools/_common.split_in_turns``) and the
interface patch that lets ``tools/compare_probe_builds.py`` build an older
csrc/probes.cu beside this one.

Inputs come from numpy seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch.kernels import probes  # noqa: E402
from vae_training_tpu_torch.ops.precision import bf16_round  # noqa: E402
from vae_training_tpu_torch.tools import probe_mlp_interleave as t4  # noqa: E402
from vae_training_tpu_torch.tools import probe_mxu_pipelining as t3  # noqa: E402

R, W = probes.ROWS, probes.W
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4
ROWS_CTA, COLS_CTA = probes.CHAIN_ROWS, probes.CHAIN_COLS
SLOT = W * COLS_CTA  # bf16 elements a ring slot: a dot's 256 k-rows
f32 = np.float32


# --- the stream form ---------------------------------------------------------

def test_stream_slot_offset_is_a_bijection_onto_the_slot():
    k, col = np.meshgrid(np.arange(W), np.arange(COLS_CTA), indexing="ij")
    off = probes.stream_slot_offset(k, col)
    assert sorted(off.ravel().tolist()) == list(range(SLOT))
    # each 32 KB block holds one 64-column block, line k row k, the chunk
    # swizzled within its line only
    assert np.array_equal(off // (W * 64), col // 64)
    assert np.array_equal(off % (W * 64) // 64, k)


def test_stream_b_reads_are_the_permuted_columns_of_the_slot():
    """The lane's 16 bytes for block p at row k hold W[k][64p + 8g + r], r =
    0..7, which is column g of n8 tile 8p + r; the 8 warps' reads of a dot
    (warp w's K slice 32w.., its two k16 steps, rows 2t, 2t + 1, 2t + 8 and
    2t + 9 of a step) cover the slot once."""
    seen = np.zeros(SLOT, int)
    for kb in range(0, W, probes.CHAIN_KSLICE):
        for step in range(2):
            for kk in (0, 1, 8, 9):
                k = kb + 16 * step + 2 * T + kk
                for p in range(COLS_CTA // 64):
                    off = probes.stream_b_offset(p, k, G)
                    for r in range(8):
                        want = probes.stream_slot_offset(k, 64 * p + 8 * G + r)
                        assert np.array_equal(off + r, want)
                        seen[off + r] += 1
    assert np.all(seen == 1)
    cols = sorted(64 * (nt // 8) + 8 * j + nt % 8 for nt in range(16) for j in range(8))
    assert cols == list(range(COLS_CTA))


def test_stream_a_reads_cover_the_warps_k_slice_once():
    hs = probes.STREAM_H_STRIDE[True]
    seen = {}
    for step in range(2):
        for reg in range(4):
            off = probes.stream_a_offset(LANES, step, reg)
            live = (G + 8 * (reg % 2)) < ROWS_CTA
            for o in (off[live], off[live] + 1):
                for v in o.tolist():
                    seen[v] = seen.get(v, 0) + 1
    want = {r * hs + k for r in range(ROWS_CTA) for k in range(probes.CHAIN_KSLICE)}
    assert set(seen) == want and set(seen.values()) == {1}


def test_stream_part_layout_and_stores_cover_the_tile_once():
    """The partial tile's layout is a bijection of 13 × 128 onto each row's
    first 128 floats, keeping float4 whole; the lanes' stores (fragment
    column 2t + x of tile 8p + r at the slice's column 64p + 16t + 8x + r)
    write each (row, column) once."""
    ps = probes.STREAM_PART_STRIDE[True]
    r, c = np.meshgrid(np.arange(ROWS_CTA), np.arange(COLS_CTA), indexing="ij")
    off = probes.stream_part_offset(r, c)
    assert np.array_equal(np.sort(off, axis=1), r * ps + c)
    assert np.array_equal(off[:, 1::4] - off[:, ::4], np.ones((ROWS_CTA, COLS_CTA // 4), int))
    seen = np.zeros(ROWS_CTA * ps, int)
    for h in range(2):
        live = G + 8 * h < ROWS_CTA
        for p in range(2):
            for x in range(2):
                for e in range(2):
                    col = probes.stream_store_col(LANES, p, x, e)
                    for e2 in range(4):  # tile 8p + 4e + e2's fragment column 2t + x
                        nt = 8 * p + 4 * e + e2
                        assert np.array_equal(col + e2, 64 * (nt // 8) + 8 * (2 * T + x) + nt % 8)
                    o = probes.stream_part_offset(G + 8 * h, col)[live]
                    for e2 in range(4):
                        np.add.at(seen, o + e2, 1)
    tile = seen.reshape(ROWS_CTA, ps)
    assert np.all(tile[:, :COLS_CTA] == 1) and np.all(tile[:, COLS_CTA:] == 0)


def _schedule_faults(mode, events, slots):
    """The stream schedule's ordering rules for a ring of ``slots`` dots,
    broken ones listed: one copy a dot, before it and after the dot ``slots``
    earlier read the stages it refills; a copy of a buffer Adam rewrote
    after that Adam, a cluster arrive and a wait; with the weights' bf16
    copy, every copy after the rounding, an arrive and a wait."""
    faults = []
    where = {e: i for i, e in enumerate(events) if e[0] in ("issue", "dot")}
    if ("round",) in events:
        r = events.index(("round",))
        first = min(i for e, i in where.items() if e[0] == "issue")
        if events[r:first].count(("arrive",)) < 1 or ("wait",) not in events[r:first]:
            faults.append("a copy before the rounding's barrier")
    for g in sorted(e[1] for e in events if e[0] == "dot"):
        issues = [i for i, e in enumerate(events) if e == ("issue", g)]
        if len(issues) != 1:
            faults.append(f"dot {g}: {len(issues)} copies")
            continue
        at = issues[0]
        if at > where[("dot", g)]:
            faults.append(f"dot {g}: copied after it ran")
        if g >= slots and at < where[("dot", g - slots)]:
            faults.append(f"dot {g}: copied before dot {g - slots} read the stages")
        if mode == "t3":
            continue
        b = probes.stream_weight(mode, 0, g)
        adams = [i for i, e in enumerate(events[:where[("dot", g)]]) if e[0] == "adam" and e[1] == b]
        if adams:
            between = [e[0] for e in events[adams[-1]:at]]
            if at < adams[-1] or "arrive" not in between or \
                    "wait" not in between[between.index("arrive"):]:
                faults.append(f"dot {g}: buffer {b} copied before Adam's release and acquire")
    return faults


@pytest.mark.parametrize("mode", ["t3", "tail", "interleaved"])
def test_stream_bf16_schedule_keeps_the_copies_in_order(mode):
    """bf16 dots stream the weights' bf16 copy through a ring of two dots:
    the CTAs write the copy first, every copy follows a cluster barrier
    behind it, dot g + 2's copies wait for dot g, and in the tail the next
    step's first two dots' copies wait for Adam's barrier. The fp32 ring
    (one dot) is the same program without the rounding."""
    ev = probes.stream_schedule(mode, 3, bf16_dots=True)
    assert ev[:5] == [("round",), ("arrive",), ("wait",), ("issue", 0), ("issue", 1)]
    assert _schedule_faults(mode, ev, 2) == []
    assert _schedule_faults(mode, probes.stream_schedule(mode, 3), 1) == []
    assert [e for e in ev if e[0] in ("dot", "adam", "renorm")] == \
        [e for e in probes.stream_schedule(mode, 3) if e[0] in ("dot", "adam", "renorm")]


def test_stream_bf16_schedule_check_fails_early_copies():
    """The controls: the tail's next step's second dot copied as dot 24 of
    the step runs (before Adam), and a two-dot ring's copy issued a dot too
    early, each fail the check."""
    ev = probes.stream_schedule("tail", 2, bf16_dots=True)
    early = [e for e in ev if e != ("issue", 26)]
    early.insert(early.index(("dot", 24)) + 1, ("issue", 26))
    assert _schedule_faults("tail", early, 2) == ["dot 26: buffer 0 copied before Adam's "
                                                  "release and acquire"]
    ev = probes.stream_schedule("t3", 1, bf16_dots=True)
    early = [e for e in ev if e != ("issue", 5)]
    early.insert(early.index(("dot", 2)) + 1, ("issue", 5))
    assert _schedule_faults("t3", early, 2) == ["dot 5: copied before dot 3 read the stages"]


# --- the bank model ----------------------------------------------------------

def _stream_instructions(layout):
    """(kind, byte addresses of the 32 lanes, bytes a lane) of every lane
    instruction of one warp's bf16 products in one dot: the redesigned
    layout, or the earlier bodies' (h rows of 256, scalar B reads of row-major stages,
    float2 stores into rows of 128)."""
    out = []
    for step in range(2):
        for reg in range(4):
            off = probes.stream_a_offset(LANES, step, reg, bf16_dots=layout == "new")
            out.append(("A pairs", [4 * int(o) for o in off], 8))
    for stage in range(probes.STREAM_STAGES):
        if layout == "new":  # a k16 step's rows 2t, 2t + 1, 2t + 8, 2t + 9, two steps
            if stage % 2:
                continue
            for p in range(2):
                for kk in (0, 1, 8, 9):
                    off = probes.stream_b_offset(p, 8 * stage + 2 * T + kk, G)
                    out.append(("B", [2 * int(o) for o in off], 16))
        else:
            for nt in range(16):
                for kk in range(2):
                    off = (2 * T + kk) * COLS_CTA + 8 * nt + G
                    out.append(("B", [4 * int(o) for o in off], 4))
    for h in range(2):
        live = G + 8 * h < ROWS_CTA
        if layout == "new":
            stores = [(probes.stream_part_offset(G + 8 * h, probes.stream_store_col(LANES, p, x, e)),
                       16) for p in range(2) for x in range(2) for e in range(2)]
        else:
            stores = [((G + 8 * h) * COLS_CTA + 8 * nt + 2 * T, 8) for nt in range(16)]
        for off, width in stores:
            out.append(("stores", [4 * int(o) if a else None for o, a in zip(off, live)], width))
    if layout == "new":  # the sums pass: a warp reads a row's float4 of each warp's tile
        for r in range(ROWS_CTA):
            out.append(("sums", [4 * int(o) for o in probes.stream_part_offset(r, 4 * LANES)], 16))
    return out


@pytest.mark.parametrize("kind", ["A pairs", "B", "stores", "sums"])
def test_stream_bf16_products_take_the_least_wavefronts(kind):
    got = [(probes.smem_wavefronts(a, w), probes.least_wavefronts(a, w))
           for k, a, w in _stream_instructions("new") if k == kind]
    assert got and all(n == least for n, least in got)


@pytest.mark.parametrize("kind", ["A pairs", "B", "stores"])
def test_pr20_stream_layout_is_bank_conflicted(kind):
    """The model's control: the earlier bodies' layout takes more than the least."""
    got = [(probes.smem_wavefronts(a, w), probes.least_wavefronts(a, w))
           for k, a, w in _stream_instructions("pr20") if k == kind]
    assert got and sum(n for n, _ in got) >= 2 * sum(least for _, least in got)


def test_stream_product_wavefronts_count():
    assert probes.stream_product_wavefronts() == {"a": 16, "b": 64, "stores": 56, "total": 136}
    new = sum(probes.smem_wavefronts(a, w) for k, a, w in _stream_instructions("new")
              if k != "sums")
    old = sum(probes.smem_wavefronts(a, w) for _, a, w in _stream_instructions("pr20"))
    assert new == 136 and old > 5 * 136


@pytest.mark.parametrize("access", ["stores", "sums"])
def test_phase_smem_accesses_take_the_least_wavefronts(access):
    if access == "stores":  # a warp's partial tile: 4 float4 stores a lane
        instrs = [[4 * int(o) for o in probes.phase_part_offset(LANES, h) + extra]
                  for h in range(2) for extra in (0, 4)]
        width = 16
    else:  # the sums: a thread reads float2 (row i // 16, columns 2(i % 16)) of each rank
        i = np.arange(32)
        instrs = [[4 * int(o) for o in
                   rank * 16 * probes.PHASE_PART_STRIDE + (i // 16 + 2 * w) * probes.PHASE_PART_STRIDE
                   + 2 * (i % 16)] for w in range(8) for rank in range(probes.PHASE_K_SPLIT)]
        width = 8
    for addrs in instrs:
        assert probes.smem_wavefronts(addrs, width) == probes.least_wavefronts(addrs, width)


def test_cluster_h_offset_is_a_bijection_onto_a_buffer():
    r, k = np.meshgrid(np.arange(probes.CLUSTER_H_ROWS), np.arange(W), indexing="ij")
    off = probes.cluster_h_offset(r, k)
    assert sorted(off.ravel().tolist()) == list(range(probes.CLUSTER_H_ROWS * W))
    # 8 bf16 of a row's chunk stay together, in order: ldmatrix's 16-byte rows
    assert np.all(off[:, 1:][:, k[0, 1:] % 8 != 0] - off[:, :-1][:, k[0, 1:] % 8 != 0] == 1)
    assert probes.CLUSTER_BF16_SMEM == 2 * off.size * 2 == 16384


def test_cluster_lanes_cover_the_ctas_outputs_and_w_slice_once():
    """Over 8 warps × 32 lanes × 4 accumulators × rows g and g + 8 (the
    zero rows 13..15 dropped), each of a CTA's 13 × 128 outputs once; over
    the lanes' B pairs (k 16s + 2t, + 1, + 8, + 9 of each of 16 steps), each
    of W's 256 × 128 values of the CTA's slice once; a warp's outputs and B
    columns are its own 16 columns."""
    out = np.zeros((ROWS_CTA, COLS_CTA), int)
    wv = np.zeros((W, COLS_CTA), int)
    for warp in range(probes.CHAIN_WARPS):
        mine = set(range(16 * warp, 16 * warp + 16))
        for lane in range(32):
            ln = probes.cluster_lane(warp, lane)
            assert set(ln["cols"]) <= mine and set(ln["b_cols"]) <= mine
            for r in ln["rows"]:
                if r < ROWS_CTA:
                    for c in ln["cols"]:
                        out[r, c] += 1
            t = lane % 4
            for s in range(16):
                for c in ln["b_cols"]:
                    for kk in (0, 1, 8, 9):
                        wv[16 * s + 2 * t + kk, c] += 1
    assert np.all(out == 1) and np.all(wv == 1)


@pytest.mark.parametrize("kind", ["ldmatrix", "stores"])
def test_cluster_bf16_accesses_take_the_least_wavefronts(kind):
    """Every ldmatrix.x4 (4 phases of 8 row addresses, 16 bytes each) and
    every 8-byte epilogue store of a warp takes the least wavefronts; rows
    of 256 bf16 without the chunk permutation put a matrix's 8 rows in one
    bank group (8 wavefronts a matrix)."""
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for warp in range(probes.CHAIN_WARPS):
        ln = probes.cluster_lane(warp, lanes)
        if kind == "ldmatrix":
            instrs = [([2 * int(o) for o in probes.cluster_h_offset(*ln["a_row"](s))], 16)
                      for s in range(16)]
        else:
            instrs = []
            for h in range(2):
                live = g + 8 * h < ROWS_CTA
                off = probes.cluster_h_offset(g + 8 * h, 16 * warp + 4 * t)
                instrs.append(([2 * int(o) if a else None for o, a in zip(off, live)], 8))
        for addrs, width in instrs:
            assert probes.smem_wavefronts(addrs, width) == probes.least_wavefronts(addrs, width)
    assert probes.cluster_wavefronts() == {"ldmatrix": 64, "stores": 4, "total": 68}
    assert probes.cluster_wavefronts(lambda r, k: r * W + k)["ldmatrix"] == 8 * 64


# --- the phase form's cut ----------------------------------------------------

# the two dot modes' cuts: (columns a unit, units a CTA a round, units a chain)
PHASE_CUTS = {True: (probes.PHASE_COLS, probes.PHASE_SLOTS, 56),
              False: (probes.PHASE_COLS_FP32, probes.PHASE_SLOTS_FP32, 112)}


@pytest.mark.parametrize("n_chains", [1, 2, 3, 4])
@pytest.mark.parametrize("blocks", [132, 20])
@pytest.mark.parametrize("bf16_dots", [True, False], ids=["bf16", "fp32"])
def test_phase_units_own_every_output_once(n_chains, blocks, bf16_dots):
    cols, slots, per_chain = PHASE_CUTS[bf16_dots]
    units = probes.phase_units(n_chains, blocks, bf16_dots=bf16_dots)
    assert len(units) == n_chains * per_chain
    owned = np.zeros((n_chains, 16 * probes.PHASE_M_TILES, W), int)
    places = set()
    for u in units:
        owned[u["chain"], 16 * u["mt"]:16 * u["mt"] + 16, cols * u["nq"]:cols * (u["nq"] + 1)] += 1
        places.add((u["block"], u["slot"], u["round"]))
        assert 0 <= u["block"] < blocks and 0 <= u["slot"] < slots
    assert np.all(owned == 1)
    assert len(places) == len(units)  # no two units on one slot of a CTA in one round
    if blocks == 132:
        assert max(u["round"] for u in units) == 0  # one round up to 4 chains on 132 SMs


@pytest.mark.parametrize("n_chains", [2, 3, 4])
@pytest.mark.parametrize("bf16_dots", [True, False], ids=["bf16", "fp32"])
def test_phase_units_arithmetic_does_not_depend_on_the_chain_count(n_chains, bf16_dots):
    """Each chain's units are chain 0's alone (the same m16 tiles and column
    groups in the same order; their K split, ``phase_lane_loads`` in bf16
    dots and ``phase_fp32_lane`` in fp32, takes no chain count), so a
    chain's sums are taken in one order at any chain count; only the CTA,
    slot and round that run a unit differ."""
    one = [(u["mt"], u["nq"]) for u in probes.phase_units(1, 132, bf16_dots=bf16_dots)]
    units = probes.phase_units(n_chains, 132, bf16_dots=bf16_dots)
    for c in range(n_chains):
        assert [(u["mt"], u["nq"]) for u in units if u["chain"] == c] == one


@pytest.mark.parametrize("mt", [0, probes.PHASE_M_TILES - 1])
def test_phase_lane_loads_cover_each_outputs_k_once(mt):
    """Over a unit's 8 warps, 2 steps and the lanes' float4, A covers its 16
    rows × 256 k once and B its 256 k × 32 columns once; the fragment
    positions of a step stand for its 16 k in some order."""
    nq = 2
    a_seen = np.zeros((16, W), int)
    b_seen = np.zeros((W, probes.PHASE_COLS), int)
    for kq in range(probes.PHASE_K_SPLIT):
        a, b = probes.phase_lane_loads(mt, nq, kq, LANES)
        for s in range(2):
            for (row, k) in a[s]:
                for e in range(4):
                    np.add.at(a_seen, (row - 16 * mt, k + e), 1)
            for k, col in b[s]:
                for e in range(4):
                    np.add.at(b_seen, (k, col + e - probes.PHASE_COLS * nq), 1)
            # a k16 step's positions: lane t's float4 at k 16(2kq + s) + 4t ..
            ks = np.array([k for k, _ in b[s]])  # (4, 32)
            assert sorted(set(ks.ravel().tolist())) == list(
                range(32 * kq + 16 * s, 32 * kq + 16 * s + 16))
    assert np.all(a_seen == 1) and np.all(b_seen == 1)


# --- one bf16 dot through the mirrored addresses -----------------------------

def _mma(a, b):
    """mma.sync m16n8k16 from zero: ``a`` (32, 4, 2) and ``b`` (32, 2, 2) the
    lanes' fragment registers (bf16 values as float32); the 16 products of an
    output exact, summed and rounded once to float32. Returns (32, 4)."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for e in range(2):
            A[G + dr, 2 * T + dk + e] = a[:, reg, e]
    for reg in range(2):
        for e in range(2):
            B[2 * T + 8 * reg + e, G] = b[:, reg, e]
    D = (A @ B).astype(f32)
    return np.stack([D[G, 2 * T], D[G, 2 * T + 1], D[G + 8, 2 * T], D[G + 8, 2 * T + 1]], 1)


def _phase_dot(h, w):
    """One chain's bf16 dot by the phase form's units (h (R, W), w (W, W),
    both bf16 values in float32)."""
    hp = np.zeros((16 * probes.PHASE_M_TILES, W), f32)
    hp[:R] = h
    out = np.zeros((R, W), f32)
    for u in probes.phase_units(1, 132):
        mt, nq = u["mt"], u["nq"]
        parts = []
        for kq in range(probes.PHASE_K_SPLIT):
            a_at, b_at = probes.phase_lane_loads(mt, nq, kq, LANES)
            acc = np.zeros((32, 4, 4), f32)  # [lane, tile r, register]
            for s in range(2):
                (r0, k0), (r1, _) = a_at[s]
                v0 = np.stack([hp[r0, k0 + e] for e in range(4)], 1)
                v1 = np.stack([hp[r1, k0 + e] for e in range(4)], 1)
                a = np.stack([v0[:, :2], v1[:, :2], v0[:, 2:], v1[:, 2:]], 1)
                wb = [np.stack([w[k, col + e] for e in range(4)], 1) for k, col in b_at[s]]
                for r in range(4):
                    b = np.stack([np.stack([wb[0][:, r], wb[1][:, r]], 1),
                                  np.stack([wb[2][:, r], wb[3][:, r]], 1)], 1)
                    acc[:, r] += _mma(a, b)
            part = np.zeros(16 * probes.PHASE_PART_STRIDE, f32)
            for h_ in range(2):
                off = probes.phase_part_offset(LANES, h_)
                for r in range(4):
                    part[off + r] = acc[:, r, 2 * h_]
                    part[off + 4 + r] = acc[:, r, 2 * h_ + 1]
            parts.append(part.reshape(16, probes.PHASE_PART_STRIDE))
        y = parts[0].copy()
        for p in parts[1:]:
            y += p
        rows = slice(16 * mt, min(16 * mt + 16, R))
        out[rows, probes.PHASE_COLS * nq:probes.PHASE_COLS * (nq + 1)] = \
            y[:rows.stop - rows.start, :probes.PHASE_COLS]
    return out


def _stream_dot(h, w):
    """One chain's bf16 dot by the stream form's 16 CTAs (h (R, W), w (W, W),
    both bf16 values in float32; the stages hold w's bf16 copy)."""
    hs = probes.STREAM_H_STRIDE[True]
    out = np.zeros((R, W), f32)
    k_loc, c_loc = np.meshgrid(np.arange(W), np.arange(COLS_CTA), indexing="ij")
    offsets = probes.stream_slot_offset(k_loc, c_loc)
    rr, cc = np.meshgrid(np.arange(ROWS_CTA), np.arange(COLS_CTA), indexing="ij")
    read = probes.stream_part_offset(rr, cc)
    for block in range(probes.CHAIN_CLUSTER):
        cta = probes.stream_cta(1, block)
        (r0, r1), (c0, c1) = cta["rows"], cta["cols"]
        hsm = np.zeros(ROWS_CTA * hs, f32)
        for r in range(ROWS_CTA):
            hsm[r * hs:r * hs + W] = h[r0 + r]
        slot = np.zeros(SLOT, f32)  # the copy's layout
        slot[offsets] = w[:, c0:c1]
        tiles = []
        for warp in range(probes.CHAIN_WARPS):
            kb = cta["k_slices"][warp][0]
            acc = np.zeros((32, 16, 4), f32)
            for step in range(2):
                a = np.zeros((32, 4, 2), f32)
                for reg in range(4):
                    off = kb + probes.stream_a_offset(LANES, step, reg)
                    live = G + 8 * (reg % 2) < ROWS_CTA
                    a[:, reg] = np.where(live[:, None], np.stack([hsm[off], hsm[off + 1]], 1), 0)
                k = kb + 16 * step + 2 * T
                for p in range(2):
                    x, y, z, u = (np.stack([slot[probes.stream_b_offset(p, k + kk, G) + e]
                                            for e in range(8)], 1) for kk in (0, 1, 8, 9))
                    for r in range(8):
                        b = np.stack([np.stack([x[:, r], y[:, r]], 1),
                                      np.stack([z[:, r], u[:, r]], 1)], 1)
                        acc[:, 8 * p + r] += _mma(a, b)
            part = np.zeros(ROWS_CTA * probes.STREAM_PART_STRIDE[True], f32)
            for h_ in range(2):
                live = G + 8 * h_ < ROWS_CTA
                for p in range(2):
                    for x in range(2):
                        for e in range(2):
                            off = probes.stream_part_offset(
                                G + 8 * h_, probes.stream_store_col(LANES, p, x, e))[live]
                            for e2 in range(4):
                                part[off + e2] = acc[live, 8 * p + 4 * e + e2, 2 * h_ + x]
            tiles.append(part[read])
        y = tiles[0].copy()
        for p in tiles[1:]:
            y += p
        out[r0:r1, c0:c1] = y
    return out


def _cluster_dot(h, w):
    """One chain's bf16 dot by the cluster form's 16 CTAs (h (R, W), w (W, W),
    both bf16 values in float32): each CTA's rows of h in its buffer at
    cluster_h_offset (rows 13..15 zeros), each lane's A fragments as
    ldmatrix gives them (matrix m's row from lane 8m + g, its elements 2t
    and 2t + 1), its B pairs from W at its columns, 16 k16 partials from
    zero added in ascending k."""
    out = np.zeros((R, W), f32)
    for block in range(probes.CHAIN_CLUSTER):
        cta = probes.chain_cta(probes.chain_plan(1), block)
        (r0, r1), (c0, _) = cta["rows"], cta["cols"]
        buf = np.zeros(probes.CLUSTER_H_ROWS * W, f32)
        rr, kk = np.meshgrid(np.arange(ROWS_CTA), np.arange(W), indexing="ij")
        buf[probes.cluster_h_offset(rr, kk)] = h[r0:r1]
        for warp in range(probes.CHAIN_WARPS):
            ln = probes.cluster_lane(warp, LANES)
            acc = np.zeros((32, 2, 4), f32)
            for s in range(16):
                row_at = probes.cluster_h_offset(*ln["a_row"](s))  # lane L: matrix L // 8's row
                a = np.zeros((32, 4, 2), f32)
                for m in range(4):
                    for e in range(2):
                        a[:, m, e] = buf[row_at[8 * m + G] + 2 * T + e]
                for r in range(2):
                    b = np.zeros((32, 2, 2), f32)
                    for reg in range(2):
                        for e in range(2):
                            b[:, reg, e] = w[16 * s + 2 * T + 8 * reg + e, c0 + ln["b_cols"][r]]
                    acc[:, r] += _mma(a, b)
            for h_ in range(2):
                live = G + 8 * h_ < ROWS_CTA
                vals = [acc[:, 0, 2 * h_], acc[:, 1, 2 * h_], acc[:, 0, 2 * h_ + 1],
                        acc[:, 1, 2 * h_ + 1]]
                for j in range(4):
                    out[r0 + (G + 8 * h_)[live], c0 + ln["cols"][j][live]] = vals[j][live]
    return out


def _inputs(kind):
    """(xs, ws) of one chain, ws one (W, W) weight."""
    if kind == "T4 two-term":
        xs, ws = t4.two_term_inputs(1, "cpu")
    elif kind == "T3 two-term":
        xs, ws = t3.two_term_inputs(1, "cpu")
    elif kind == "T4 dense":
        xs, ws = t4.check_inputs(1, "cpu")
    else:
        xs, ws = t3.inputs(1, "cpu")
    return xs, ws[:, :W].contiguous()


@pytest.mark.parametrize("form", ["phase", "stream", "cluster"])
@pytest.mark.parametrize("kind", ["T4 two-term", "T3 two-term", "T4 dense", "T3 dense"])
def test_one_bf16_dot_through_the_mirrored_addresses(form, kind):
    xs, ws = _inputs(kind)
    kw = dict(n_steps=1, depth=1, weights_per_depth=False, epilogue="clamp")
    want = probes.plain_chain_chunk(xs, ws, bf16_dots=True, **kw)[0].numpy()
    f32_ = probes.plain_chain_chunk(xs, ws, **kw)[0].numpy()
    h, w = (bf16_round(t[0]).numpy() for t in (xs, ws))
    got = {"phase": _phase_dot, "stream": _stream_dot, "cluster": _cluster_dot}[form](h, w)
    got = np.minimum(got, f32(probes.CLAMP))
    if "two-term" in kind:
        assert np.array_equal(got, want)
        assert not np.array_equal(f32_, want)
    else:
        rho = np.linalg.norm((got - want).astype(np.float64)) / np.linalg.norm(
            (f32_ - want).astype(np.float64))
        assert rho <= 1e-3, rho
        assert not np.array_equal(got, f32_)


@pytest.mark.parametrize("n_chains", [1, 4])
def test_dense_trip_is_one_dense_dot(n_chains):
    """T3's dense_trip_inputs (7 identities, then the first weight): in bf16
    dots the trip equals one dot by the first weight, bitwise (the
    identities only round h to bf16, which the dense dot rounds anyway);
    the card holds the stream form to it one dense dot deep."""
    xs, ws = t3.dense_trip_inputs(n_chains, "cpu")
    trip = probes.plain_chain_chunk(xs, ws, n_steps=1, depth=probes.T3_DEPTH,
                                    weights_per_depth=True, epilogue="renorm", bf16_dots=True)
    one = probes.plain_chain_chunk(xs, ws[:, -W:].contiguous(), n_steps=1, depth=1,
                                   weights_per_depth=True, epilogue="renorm", bf16_dots=True)
    assert torch.equal(trip, one)
    assert torch.equal(ws[:, -W:], t3.inputs(n_chains, "cpu")[1][:, :W])


# --- the splits' timing order and the comparison tool's interface patch ------

def test_split_in_turns_times_variants_in_order_then_reverse_launches_in_turn(monkeypatch):
    """Every variant is timed twice, in order and then in reverse, each
    launch in turn at each; the least of the two times, scaled, is kept."""
    from vae_training_tpu_torch.tools import _common

    calls, times = [], iter(range(100, 0, -1))

    def fake_event_us(fn):
        fn()
        return float(next(times))

    monkeypatch.setattr(_common, "event_us", fake_event_us)
    got = _common.split_in_turns(
        {"this": lambda u: calls.append(("this", u)), "other": lambda u: calls.append(("other", u))},
        ("a", "b", "c"), scale=0.5)
    assert calls == [(n, u) for u in "abccba" for n in ("this", "other")]
    # times fall call by call, so each variant's second (reversed) time is kept
    assert got == {"this": {"a": 45.0, "b": 46.0, "c": 47.0},
                   "other": {"a": 44.5, "b": 45.5, "c": 46.5}}


def test_interface_patch_refuses_a_file_it_does_not_fit():
    """The patch applies only where each old text occurs once: this tree's
    csrc/probes.cu, which has the interface already, is refused; the C
    entry it patches in (the cluster form's, without the plan's shared
    bytes and grid) is declared as this tree declares it."""
    from vae_training_tpu_torch.tools import compare_probe_builds as cmp

    src = (cmp.ROOT / cmp.SOURCE).read_text()
    with pytest.raises(ValueError):
        cmp.with_this_interface(src)
    entries = [new for _, new in cmp.INTERFACE_PATCH if new.startswith("int probes_")]
    assert len(entries) == 1
    for new in entries:
        assert src.count(new) == 1, new.splitlines()[0]
