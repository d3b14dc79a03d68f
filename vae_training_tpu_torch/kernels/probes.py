"""T2–T5: the probes of the MLP kernel's design — CUDA wrappers and plain
versions.

Ports of the TPU probes' Pallas kernels (each a ``pl.pallas_call``):

- T4, ``tools/probe_mlp_interleave.py:62`` (``run`` → ``_chain_kernel``):
  ``chain_chunk`` with identity-like weights, ``min(·, 8)`` after each dot,
  in two forms: ``"phase"`` (the MLP kernel's former design:
  one cooperative launch, a grid-wide phase a dot, cut into the units of
  ``phase_units``) and ``"cluster"`` (a cluster of 16 CTAs a chain, 8 row
  groups × 2 column slices, each CTA's rows pushed to its row group's other
  CTA after a dot; the plan of ``chain_plan``);
- T3, ``tools/probe_mxu_pipelining.py:82`` (``run`` → ``make_kernel``):
  ``chain_chunk`` with ``weights_per_depth`` (8 distinct weights a chain)
  and ``epilogue="renorm"``, in two forms: ``"phase"`` and ``"stream"``
  (T4's cluster plan with each warp's K slice of the next dot's weights
  streamed from L2 into a ring in shared memory; the events of
  ``stream_schedule``, the partition of ``stream_cta``);
- T5, ``tools/probe_adam_overlap.py:110`` (``run`` → ``_kernel``):
  ``adam_overlap_chunk``, 25 dots and Adam on 5 buffers, in a tail or
  interleaved, in the same two forms;
- T2, ``tools/check_precision.py:43`` (``check_dot_modes`` → ``mk``):
  ``dot_modes``, one dot in fp32 (CUDA-core FMAs), or on the tensor cores
  (``wgmma``) with TF32 or bf16 operands; split-K over a thread-block
  cluster, on the plan of ``dot_plan``.

T3, T4 and T5 take ``bf16_dots``: every dot with both operands rounded to
bfloat16 (round to nearest even) and f32 sums, what the TPU tools' dots at
``precision=None`` compute (T2's ``check_dot_modes``), on the tensor cores
(``mma.sync`` m16n8k16) in every form; h, the weights, the clamp, T3's
renorm and T5's Adam stay f32. Without it the dots are fp32. The bf16
instantiations' cuts and shared-memory layouts are mirrored here as plain
index arithmetic (``phase_units``, ``phase_lane_loads``, ``phase_part_offset``,
``stream_slot_offset``, ``stream_b_offset``, ``stream_a_offset``,
``stream_part_offset``, ``stream_store_col``, ``cluster_h_offset``,
``cluster_lane``; the stream form's bf16 instantiation streams a bf16 copy
of the weights, which its launch writes into scratch the wrapper
allocates), which ``tests/test_torch_probe_layouts.py`` checks; so is the
phase form's fp32 cut (``phase_units(..., bf16_dots=False)``,
``phase_fp32_lane``, ``phase_fp32_copies``, ``phase_fp32_sum_row``),
which ``tests/test_torch_phase_plan.py`` checks.

The kernels are ``csrc/probes.cu``. Each wrapper launches its kernel for
CUDA tensors and raises if it cannot; for CPU tensors (and only for them) it
runs its plain PyTorch version, which repeats the tool's math step by step
(``torch.matmul`` for the dots, of operands rounded by
``ops/precision.bf16_round`` with ``bf16_dots``). Each wrapper counts its
launches in ``.launches`` (``.cluster_launches`` and ``.stream_launches``
for those forms), and its bf16-dot launches apart, in ``.bf16_launches``
(``.bf16_cluster_launches``, ``.bf16_stream_launches``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.precision import bf16_round
from .linear_vae import _require

ROWS = 104  # the sphere sweep's batch 100, rounded to 8 (the tools' ROWS / M)
W = 256  # its hidden width 200, rounded to 256 (the tools' W / K / N)
T4_DEPTH = 24  # dependent dots a step (probe_mlp_interleave.DEPTH)
T3_DEPTH = 8  # distinct weights a chain (probe_mxu_pipelining.DEPTH)
N_BUF, DOTS_PER_BUF = 5, 5  # probe_adam_overlap's weight buffers and dots a buffer
B1, B2, EPS = 0.9, 0.999, 1e-8
ADAM_LR = 1e-9  # probe_adam_overlap's learning rate
CLAMP = 8.0
MAX_CHAINS = 4
EPILOGUES = {"clamp": 0, "renorm": 1}
FORMS = ("phase", "cluster", "stream")  # chain_chunk's
T4_FORMS = ("phase", "cluster")  # T4's forms (one weight a chain, the clamp)
T3_FORMS = T5_FORMS = ("phase", "stream")  # T3's (chain_chunk), T5's (adam_overlap_chunk)
# T4's cluster form (csrc/probes.cu chain_cluster_kernel): a cluster of 16
# CTAs a chain, 8 row groups × 2 column slices of 128 (a lane 4 columns),
# 8 warps a CTA splitting K (fp32) or N (bf16 dots), W in registers
CHAIN_CLUSTER, CHAIN_SLICES, CHAIN_WARPS = 16, 2, 8
CHAIN_ROWS = ROWS // (CHAIN_CLUSTER // CHAIN_SLICES)  # 13 rows a CTA: one m16 tile in bf16
CHAIN_COLS, CHAIN_KSLICE = W // CHAIN_SLICES, W // CHAIN_WARPS  # 128 columns a CTA, 32 k a warp
# launch variants for the time split (``_chain_cluster_launch``): stop after
# staging W and x, after the products, after the store into the CTA's own
# next h (fp32: with the partial tiles' sums; bf16: the clamp and the
# rounding), or run whole (the push to the row group's other CTA and the wait)
CHAIN_UPTO = {"stage": 0, "products": 1, "store": 2, "all": 3}
# the cluster form's bf16 cut: warp w owns 16 of its CTA's columns (two n8
# tiles) over the whole K (16 k16 steps); h in shared memory as bf16, 16
# rows a buffer (13, then zeros), rows of 256 with each 128-byte line's
# 16-byte chunks permuted by the row (``cluster_h_offset``); 2 × 16 × 256 × 2
# bytes of shared memory a CTA
CLUSTER_WARP_COLS, CLUSTER_H_ROWS = CHAIN_COLS // CHAIN_WARPS, 16
CLUSTER_BF16_SMEM = 2 * CLUSTER_H_ROWS * W * 2
# T3's and T5's stream form (csrc/probes.cu chain_stream_kernel): T4's cut;
# each warp's ring holds 4 stages of 8 k-rows of its K slice (one dot's);
# a CTA's Adam takes 32 rows of W (8 bands) × its 128 columns
STREAM_MODES = {"t3": 0, "tail": 1, "interleaved": 2}
STREAM_STAGES, STREAM_CHUNK_K, STREAM_ADAM_ROWS = 4, 8, 32
# launch variants for the time split (``_stream_launch``): stream the
# weights alone; the products alone (from the first dot's chunks, no
# stream); the products with the stream; + the sums and the row exchange;
# or run whole (+ T3's renorm or T5's Adam)
STREAM_UPTO = {"weights": 0, "compute": 1, "products": 2, "exchange": 3, "all": 4}
# the stream form's bf16 layout: the weights' bf16 copy streamed, one copy a
# CTA a dot into one of two ring slots, a slot two 32 KB blocks of the dot's
# 256 k-rows × 64 bf16 columns, swizzled 128 B by its copy; h's rows 264
# floats apart, the partial tiles' 132 with swizzled chunks (fp32: 4 copies
# a warp a dot, a ring of one dot; h and the tiles as they are)
STREAM_BLOCK_COLS = 64
STREAM_SLOTS = {False: 1, True: 2}  # dots the ring holds
STREAM_H_STRIDE = {False: W, True: W + 8}
STREAM_PART_STRIDE = {False: W // CHAIN_SLICES, True: W // CHAIN_SLICES + 4}
# the phase form's launch variants for the time split (``_phase_launch``):
# every phase empty but for its grid barrier; every phase's work without the
# barriers; or whole
PHASE_UPTO = {"barriers": 0, "work": 1, "all": 2}
# the phase form's bf16 cut (csrc/probes.cu phase_dot_bf16): units of 16 rows
# × 32 columns of a chain, K split over 8 warps of 32 k (two k16 steps), two
# units a 512-thread CTA a round; the partial tiles' rows 36 floats apart
PHASE_COLS, PHASE_K_SPLIT, PHASE_SLOTS, PHASE_PART_STRIDE = 32, 8, 2, 36
PHASE_M_TILES = -(-ROWS // 16)  # 7 m16 tiles a chain, the last half zeros
PHASE_UNITS = PHASE_M_TILES * (W // PHASE_COLS)  # 56 a chain
# its fp32 cut (phase_dot_fp32): units of 16 rows × 16 columns, K split over
# 8 half-warps of 32 k (4 warps a unit), four units a CTA a round; a
# half-warp's stage holds its h slice (16 rows of 36 floats) then its W
# slice (32 k-rows of 16), and then its partial tile (rows of 20)
PHASE_COLS_FP32, PHASE_SLOTS_FP32 = 16, 4
PHASE_UNITS_FP32 = PHASE_M_TILES * (W // PHASE_COLS_FP32)  # 112 a chain
PHASE_H_STRIDE_FP32, PHASE_PART_STRIDE_FP32 = W // PHASE_K_SPLIT + 4, PHASE_COLS_FP32 + 4
PHASE_STAGE_FP32 = 16 * PHASE_H_STRIDE_FP32 + (W // PHASE_K_SPLIT) * PHASE_COLS_FP32
PHASE_SMEM_FP32 = 4 * PHASE_SLOTS_FP32 * PHASE_K_SPLIT * PHASE_STAGE_FP32  # dynamic, a CTA
MODES = {"fp32": 0, "tf32": 1, "bf16": 2}
# T2's kernel (csrc/probes.cu dot_kernel): one warpgroup a CTA, 64 × 32 output
# tiles, K staged 32 at a time, slices of whole 16-element units, clusters of
# at most 8 CTAs (the portable size), at most 132 CTAs (the H100's SMs) from
# the split; the staged A's row stride 36 floats, the partial sums' 40
DOT_THREADS, DOT_TILE_M, DOT_TILE_N, DOT_CHUNK_K, DOT_UNIT_K = 128, 64, 32, 32, 16
DOT_MAX_SPLIT, DOT_MAX_BLOCKS, DOT_RAW_STRIDE, DOT_P_STRIDE = 8, 132, 36, 40
DOT_MAX_SMEM = 232448  # a CTA's shared memory on Hopper
# launch variants for the time split (``_dot_launch``): stop after the launch,
# the staging, the products, or run whole
DOT_UPTO = {"launch": 0, "stage": 1, "products": 2, "all": 3}

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ._build import load_library

        _LIB = bind(load_library("probes")[0])
    return _LIB


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the probes library's C entries on ``lib`` (a build of
    csrc/probes.cu); returns it."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probes_error_string.argtypes = [i32]
    lib.probes_error_string.restype = ctypes.c_char_p
    lib.probes_chain_phase.argtypes = [vp] * 5 + [i32] * 9 + [vp]
    lib.probes_chain_phase.restype = i32
    lib.probes_chain_cluster.argtypes = [vp] * 3 + [i32] * 5 + [vp]
    lib.probes_chain_cluster.restype = i32
    lib.probes_chain_stream.argtypes = [vp] * 6 + [i32] * 6 + [vp]
    lib.probes_chain_stream.restype = i32
    lib.probes_dot.argtypes = [vp] * 3 + [i32] * 9 + [vp]
    lib.probes_dot.restype = i32
    lib.probes_dot_plan.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.probes_dot_plan.restype = i32
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.probes_error_string(err).decode()})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _count(wrapper, name: str, bf16_dots: bool) -> None:
    """One launch more on ``wrapper``'s counter ``name``, or on its bf16-dot
    twin ``bf16_<name>``."""
    name = f"bf16_{name}" if bf16_dots else name
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def _chain_shapes(xs, ws, depth, weights_per_depth, epilogue, form) -> int:
    if xs.dim() != 3 or tuple(xs.shape[1:]) != (ROWS, W) or not 1 <= xs.shape[0] <= MAX_CHAINS:
        raise ValueError(f"xs must be (chains ≤ {MAX_CHAINS}, {ROWS}, {W}), got "
                         f"{tuple(xs.shape)}")
    n = xs.shape[0]
    want = (n, depth * W if weights_per_depth else W, W)
    if tuple(ws.shape) != want:
        raise ValueError(f"ws must be {want}, got {tuple(ws.shape)}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {sorted(EPILOGUES)}, got {epilogue!r}")
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if form == "cluster" and (weights_per_depth or epilogue != "clamp"):
        raise ValueError("the cluster form is T4's: one weight a chain, the clamp epilogue")
    if form == "stream" and (not weights_per_depth or epilogue != "renorm" or depth != T3_DEPTH):
        raise ValueError(f"the stream form is T3's: {T3_DEPTH} distinct weights a chain, the "
                         "renorm epilogue")
    return n


def chain_chunk(xs: torch.Tensor, ws: torch.Tensor, *, n_steps: int, depth: int,
                weights_per_depth: bool, epilogue: str, form: str = "phase",
                bf16_dots: bool = False) -> torch.Tensor:
    """``n_steps`` trips of ``depth`` dependent dots h ← h·W on each of the
    chains ``xs`` (chains, ROWS, W); returns the final h. ``ws`` is one
    (W, W) weight a chain, or with ``weights_per_depth`` ``depth`` of them
    stacked, (depth·W, W), dot d using rows d·W..(d+1)·W (T3). ``epilogue``
    "clamp" takes min(·, 8) after every dot (T4); "renorm" scales each
    chain's h by 1/max(max|h|, 1e-6) after each trip (T3). ``form``
    "cluster" is T4's second kernel (one weight a chain, the clamp only),
    "stream" T3's (8 distinct weights a chain, the renorm only).
    ``bf16_dots``: every dot of bf16-rounded operands with f32 sums."""
    n = _chain_shapes(xs, ws, depth, weights_per_depth, epilogue, form)
    if xs.device.type == "cpu":
        return plain_chain_chunk(xs, ws, n_steps=n_steps, depth=depth,
                                 weights_per_depth=weights_per_depth, epilogue=epilogue,
                                 bf16_dots=bf16_dots)
    if xs.device.type != "cuda":
        raise ValueError(f"chain_chunk takes CPU or CUDA tensors, got {xs.device}")
    device = xs.device
    _require(xs, "xs", device)
    _require(ws, "ws", device)
    if n_steps < 1 or depth < 1:
        raise ValueError(f"n_steps and depth must be ≥ 1, got {n_steps} and {depth}")
    if form == "cluster":
        out = _chain_cluster_launch(xs, ws, n_steps, depth, bf16_dots=bf16_dots)
        _count(chain_chunk, "cluster_launches", bf16_dots)
        return out
    if form == "stream":
        out = _stream_launch("t3", xs, ws, None, None, n_steps, bf16_dots=bf16_dots)
        _count(chain_chunk, "stream_launches", bf16_dots)
        return out
    out = _phase_launch(xs, ws, n_steps, depth, weights_per_depth, epilogue, bf16_dots=bf16_dots)
    _count(chain_chunk, "launches", bf16_dots)
    return out


chain_chunk.launches = chain_chunk.bf16_launches = 0
chain_chunk.cluster_launches = chain_chunk.bf16_cluster_launches = 0
chain_chunk.stream_launches = chain_chunk.bf16_stream_launches = 0


def _phase_launch(xs: torch.Tensor, ws: torch.Tensor, n_steps: int, depth: int,
                  weights_per_depth: bool, epilogue: str, adam: int = 0,
                  ms: Optional[torch.Tensor] = None, vs: Optional[torch.Tensor] = None,
                  t0: int = 0, upto: str = "all", bf16_dots: bool = False) -> torch.Tensor:
    """One launch of the phase form on CUDA tensors (T3, T4; T5 with
    ``adam`` 1 (tail) or 2 (interleaved), ``ms`` and ``vs``): returns the
    final h. ``upto`` other than "all" runs a variant of the time split (the
    result is then not the chain's). Uncounted."""
    n, device = xs.shape[0], xs.device
    h = torch.empty(2, *xs.shape, dtype=torch.float32, device=device)
    h[0].copy_(xs)
    maxbits = torch.zeros(2 * n, dtype=torch.int32, device=device)
    lib = _lib()
    err = lib.probes_chain_phase(
        h.data_ptr(), ws.data_ptr(), None if ms is None else ms.data_ptr(),
        None if vs is None else vs.data_ptr(), maxbits.data_ptr(), n, n_steps, depth,
        DOTS_PER_BUF if adam else (1 if weights_per_depth else depth), EPILOGUES[epilogue],
        adam, t0, int(bf16_dots), PHASE_UPTO[upto], _stream(device))
    _check(lib, err, "probes_chain_phase launch" if not adam else
           "probes_chain_phase (Adam) launch")
    return h[(n_steps * depth) % 2]


def phase_units(n_chains: int, blocks: int, bf16_dots: bool = True) -> list:
    """The phase form's cut of one dot, by the kernel's index arithmetic
    (csrc/probes.cu phase_dot_bf16, or phase_dot_fp32 without ``bf16_dots``):
    each unit's chain, m16 tile and column group (32 columns in bf16 dots,
    16 in fp32), the CTA and slot that compute it and the round they do it
    in (unit u in CTA u mod blocks, slot u // blocks mod slots, round u //
    (slots · blocks); slots 2 (bf16, half a CTA each) or 4 (fp32, 4 warps
    each)). Each unit's 8 warps (bf16, ``phase_lane_loads``) or half-warps
    (fp32, ``phase_fp32_lane``) split its K."""
    cols = PHASE_COLS if bf16_dots else PHASE_COLS_FP32
    per_chain = PHASE_UNITS if bf16_dots else PHASE_UNITS_FP32
    units = []
    per_round = (PHASE_SLOTS if bf16_dots else PHASE_SLOTS_FP32) * blocks
    for u in range(n_chains * per_chain):
        c, rem = divmod(u, per_chain)
        mt, nq = divmod(rem, W // cols)
        units.append({"unit": u, "chain": c, "mt": mt, "nq": nq, "block": u % blocks,
                      "slot": u % per_round // blocks, "round": u // per_round})
    return units


def phase_lane_loads(mt, nq, kq, lane):
    """The loads of lane ``lane`` of warp ``kq`` of a phase unit (m16 tile
    ``mt``, column group ``nq``), all float4 of a chain's h and W: A, a list
    over the warp's two k16 steps of ((row, k), (row + 8, k)) (row + 8 is not
    loaded past ROWS); B, a list over the steps of 4 (k, col). The lane (g,
    t) holds fragment positions 2t, 2t + 1, 2t + 8, 2t + 9 of a step, which
    stand for the step's k 4t .. 4t + 3, and n8 tile r's column j is the
    group's column 4j + r. Works on numpy arrays of lanes."""
    g, t = lane // 4, lane % 4
    k0 = kq * (W // PHASE_K_SPLIT) + 4 * t
    a = [((16 * mt + g, k0 + 16 * s), (16 * mt + g + 8, k0 + 16 * s)) for s in range(2)]
    b = [[(k0 + 16 * s + i, PHASE_COLS * nq + 4 * g) for i in range(4)] for s in range(2)]
    return a, b


def phase_part_offset(lane, h: int):
    """The float offset, in a warp's phase partial tile (16 rows of
    PHASE_PART_STRIDE), of the lane's float4 stores of fragment registers 2h
    (offset) and 2h + 1 (offset + 4): row g + 8h, columns 8t.. and 8t + 4..."""
    g, t = lane // 4, lane % 4
    return (g + 8 * h) * PHASE_PART_STRIDE + 8 * t


def phase_fp32_lane(warp, lane) -> dict:
    """Lane ``lane`` of warp ``warp`` (0-15) of a CTA in the phase form's fp32
    cut (csrc/probes.cu phase_dot_fp32): its unit slot (warp // 4), its K
    slice's rank kq (half-warp lane // 16 of the unit's warp warp % 4), the
    unit's rows 4tm .. 4tm + 3 and columns 4tn .. 4tn + 3 it sums over k
    [32kq, 32kq + 32), l = lane % 16, (tm, tn) = (l // 4, l % 4); and the
    float offsets, in the half-warp's stage, of its float4 reads at the k
    ``k`` of each 4 (``a``: rows 4tm + i of h, 36 floats apart; ``b``:
    k-rows k + j of W at columns 4tn..) and of its partial tile's float4
    stores (``part``: rows 4tm + i, 20 floats apart). Works on numpy arrays."""
    slot, l = warp // 4, lane % 16
    kq = 2 * (warp % 4) + lane // 16
    tm, tn = l // 4, l % 4
    hs = 16 * PHASE_H_STRIDE_FP32  # W's slice follows h's in the stage
    return {"slot": slot, "kq": kq, "rows": [4 * tm + i for i in range(4)],
            "cols": [4 * tn + j for j in range(4)], "k": (32 * kq, 32 * kq + 32),
            "a": lambda k: [(4 * tm + i) * PHASE_H_STRIDE_FP32 + k for i in range(4)],
            "b": lambda k: [hs + (k + j) * PHASE_COLS_FP32 + 4 * tn for j in range(4)],
            "part": [(4 * tm + i) * PHASE_PART_STRIDE_FP32 + 4 * tn for i in range(4)]}


def phase_fp32_copies(l) -> list:
    """The 16 cp.async copies (16 bytes each) of lane ``l`` (0-15) of a
    half-warp in the phase form's fp32 cut, in issue order: ("h", row, k4)
    for h's rows of the unit and k 4·k4 .. of the half-warp's slice (8), then
    ("w", k, c4) for W's k-rows of the slice and the unit's columns 4·c4..
    (8); with the float offset in the stage each writes. Works on numpy
    arrays."""
    out = []
    for j in range(8):
        row, q = 2 * j + l // 8, l % 8
        out.append(("h", row, q, row * PHASE_H_STRIDE_FP32 + 4 * q))
    for j in range(8):
        k, q = 4 * j + l // 4, l % 4
        out.append(("w", k, q, 16 * PHASE_H_STRIDE_FP32 + k * PHASE_COLS_FP32 + 4 * q))
    return out


def phase_fp32_sum_row(i):
    """(row, column) of the unit that sum thread ``i`` (0-63 of the unit's
    128 threads) adds up, a float4 from column 4·(i % 4): rows r and r + 4
    in each quarter-warp. Works on numpy arrays."""
    return 4 * ((i >> 2) & 1) + ((i >> 3) & 3) + 8 * (i >> 5), 4 * (i & 3)


def cluster_swizzle(r):
    """The 16-byte chunk permutation of row r of the cluster form's bf16 h
    (csrc/probes.cu cl_swizzle): rows 0-3 of 8 even chunks, rows 4-7 odd."""
    return ((r & 3) << 1) | ((r >> 2) & 1)


def cluster_h_offset(r, k):
    """Where the cluster form's bf16 h buffer holds row r, k (bf16 elements;
    csrc/probes.cu cl_h_offset): rows of 256, chunk c = k // 8 at chunk
    (c & ~7) | ((c & 7) ^ cluster_swizzle(r mod 8)). Works on numpy arrays."""
    c = k >> 3
    return r * W + ((c & ~7) | ((c & 7) ^ cluster_swizzle(r & 7))) * 8 + (k & 7)


def cluster_lane(warp, lane) -> dict:
    """Lane ``lane`` of warp ``warp`` in the cluster form's bf16 cut: the
    CTA's columns whose W values it holds as B pairs for n8 tiles 0 and 1
    (``b_cols``: 16w + 2g + r, at k 16s + 2t, + 1, + 8, + 9 of each step s);
    the rows (g and g + 8; past 12 a zero row) and columns (16w + 4t .. + 3:
    tile 0's and tile 1's accumulator registers 2h, then 2h + 1, of row
    g + 8h) its accumulators hold (``rows``, ``cols``); and the (row, k) of
    h whose 16 bytes it addresses for ldmatrix at step s (``a_row``:
    matrix lane // 8's row lane % 8, k 16s + 8 (lane // 16)). Works on numpy
    arrays."""
    g, t = lane // 4, lane % 4
    c0 = CLUSTER_WARP_COLS * warp
    return {"b_cols": [c0 + 2 * g + r for r in range(2)], "rows": [g, g + 8],
            "cols": [c0 + 4 * t + j for j in range(4)],
            "a_row": lambda s: ((lane & 7) + 8 * ((lane >> 3) & 1), 16 * s + 8 * (lane >> 4))}


def cluster_wavefronts(offset=None) -> dict:
    """Shared-memory wavefronts of one warp a dot in the cluster form's bf16
    cut under the 32-bank model, through ``offset`` (bf16 element offset of
    h[r][k]; ``cluster_h_offset`` by default): the 16 ldmatrix.x4 (each 8 ×
    8 matrix one phase of 8 row addresses, 16 bytes each) and the
    epilogue's 8-byte stores of rows g and g + 8 (the peer's stores fall
    alike): {"ldmatrix", "stores", "total"}."""
    offset = cluster_h_offset if offset is None else offset
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    count = {"ldmatrix": 0, "stores": 0}
    for warp in range(CHAIN_WARPS):
        lane = cluster_lane(warp, lanes)
        for s in range(W // 16):
            r, k = lane["a_row"](s)
            count["ldmatrix"] += smem_wavefronts([2 * int(o) for o in offset(r, k)], 16)
        for h in range(2):
            live = g + 8 * h < CHAIN_ROWS
            off = offset(g + 8 * h, CLUSTER_WARP_COLS * warp + 4 * t)
            count["stores"] += smem_wavefronts(
                [2 * int(o) if a else None for o, a in zip(off, live)], 8)
    count = {key: v // CHAIN_WARPS for key, v in count.items()}  # a warp's
    count["total"] = sum(count.values())
    return count


def stream_slot_offset(k, col):
    """Where a bf16 ring slot holds W[k][col] of its dot (k < 256, col < 128
    of the CTA's columns), in bf16 elements: the 3-D copy's layout, block
    col // 64, line k, the 16-byte chunk (col % 64) // 8 swizzled to its XOR
    with k mod 8. Works on numpy arrays."""
    q, c = col // STREAM_BLOCK_COLS, col % STREAM_BLOCK_COLS
    return q * W * STREAM_BLOCK_COLS + k * STREAM_BLOCK_COLS + 8 * ((c // 8) ^ (k % 8)) + c % 8


def stream_b_offset(p, k, g):
    """The bf16 element offset, in a bf16 ring slot, of the 16 bytes that
    the lane of fragment row ``g`` reads for block ``p`` at the dot's row
    ``k``: W[k][64p + 8g .. 64p + 8g + 7], its B values of n8 tiles 8p .. 8p
    + 7 (tile 8p + r's column j is the slice's column 64p + 8j + r;
    csrc/probes.cu stream_b8). A warp's lane (g, t) reads rows kb + 16s +
    2t, + 1, + 8 and + 9 of its K slice's k16 step s."""
    return p * W * STREAM_BLOCK_COLS + k * STREAM_BLOCK_COLS + 8 * (g ^ (k % 8))


def stream_a_offset(lane, step: int, reg: int, bf16_dots: bool = True):
    """The float offset, in a CTA's h buffer from the warp's first k, of the
    float2 the lane reads for A fragment register ``reg`` (0-3) of k16 step
    ``step``: row g (+ 8 for registers 1 and 3; the zero rows 13..15 read
    row g), k 16 step + 2t (+ 8 for registers 2 and 3)."""
    g, t = lane // 4, lane % 4
    row = np.where(g + 8 * (reg % 2) < CHAIN_ROWS, g + 8 * (reg % 2), g)
    return row * STREAM_H_STRIDE[bf16_dots] + 16 * step + 2 * t + 8 * (reg // 2)


def stream_part_offset(row, col):
    """Where a bf16 partial tile of the stream form holds its row ``row``,
    column ``col`` (floats): rows 132 apart, bit 1 of the 16-byte chunk
    index flipped in the upper half of each 64 columns (csrc/probes.cu
    StreamLayout::part_offset). Works on numpy arrays."""
    return row * STREAM_PART_STRIDE[True] + (col ^ (((col >> 5) & 1) << 3))


def stream_store_col(lane, p: int, x: int, e: int):
    """The column of the float4 that the lane stores for fragment register
    x (of rows g and g + 8) of tiles 8p + 4e .. 8p + 4e + 3: fragment column
    2t + x of tile 8p + r is the slice's 64p + 16t + 8x + r."""
    return STREAM_BLOCK_COLS * p + 16 * (lane % 4) + 8 * x + 4 * e


def smem_wavefronts(addrs, width: int) -> int:
    """Shared-memory wavefronts of one warp-wide access under a 32-bank model:
    ``addrs`` the 32 lanes' byte addresses (None for a lane that does not
    access), ``width`` the bytes a lane (4, 8 or 16). The warp is served in
    phases of 128 / width lanes (a half-warp for 8 bytes, a quarter-warp for
    16); in a phase each bank serves one 4-byte word a wavefront, and lanes
    reading one word share it. The least is one wavefront a phase that has an
    active lane."""
    per_phase, total = 128 // width, 0
    for p0 in range(0, 32, per_phase):
        words = {}
        for a in addrs[p0:p0 + per_phase]:
            if a is not None:
                for w in range(a // 4, (a + width) // 4):
                    words.setdefault(w % 32, set()).add(w)
        total += max((len(v) for v in words.values()), default=0)
    return total


def least_wavefronts(addrs, width: int) -> int:
    """The least wavefronts an access of ``smem_wavefronts``'s kind can take:
    one a phase that has an active lane."""
    per_phase = 128 // width
    return sum(any(a is not None for a in addrs[p:p + per_phase]) for p in range(0, 32, per_phase))


def stream_product_wavefronts() -> dict:
    """Shared-memory wavefronts of one warp's products in one dot of the bf16
    stream form, access by access through the mirrored addresses (A pairs,
    B 16-byte loads, partial-tile float4 stores): {"a", "b", "stores",
    "total"}."""
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    count = {"a": 0, "b": 0, "stores": 0}
    for step in range(CHAIN_KSLICE // 16):
        for reg in range(4):
            count["a"] += smem_wavefronts(
                [4 * int(o) for o in stream_a_offset(lanes, step, reg)], 8)
    for step in range(CHAIN_KSLICE // 16):  # warp 0's rows; every warp's fall alike
        for p in range(CHAIN_COLS // STREAM_BLOCK_COLS):
            for k in (0, 1, 8, 9):
                count["b"] += smem_wavefronts(
                    [2 * int(o) for o in stream_b_offset(p, 16 * step + 2 * t + k, g)], 16)
    for h in range(2):
        live = g + 8 * h < CHAIN_ROWS
        for p in range(CHAIN_COLS // STREAM_BLOCK_COLS):
            for x in range(2):
                for e in range(2):
                    off = stream_part_offset(g + 8 * h, stream_store_col(lanes, p, x, e))
                    count["stores"] += smem_wavefronts(
                        [4 * int(o) if a else None for o, a in zip(off, live)], 16)
    count["total"] = sum(count.values())
    return count


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """T4's cluster form: a cluster of ``cluster`` CTAs a chain, as
    ``row_groups`` groups of ``rows`` rows × ``col_slices`` slices of
    ``cols`` columns; a CTA's ``threads`` threads as ``k_split`` warps, each
    a K slice of W (held in registers) for all the CTA's rows and columns;
    ``smem`` bytes of dynamic shared memory a CTA (h twice, the warps'
    partial tiles); ``grid`` CTAs."""
    cluster: int
    row_groups: int
    col_slices: int
    rows: int
    cols: int
    k_split: int
    threads: int
    smem: int
    grid: int


def chain_plan(n_chains: int) -> ChainPlan:
    """The plan of T4's cluster form for ``n_chains`` chains, whose fields
    are csrc/probes.cu's constants (kChain*; ``smem`` the fp32
    instantiation's, ``CLUSTER_BF16_SMEM`` the bf16 one's) but the grid, 16
    CTAs a chain. ``k_split`` and ``chain_cta``'s K slices are the fp32 cut
    and the stream form's; the bf16 cluster cut splits N (``cluster_lane``)."""
    if not 1 <= n_chains <= MAX_CHAINS:
        raise ValueError(f"n_chains must be 1..{MAX_CHAINS}, got {n_chains}")
    groups = CHAIN_CLUSTER // CHAIN_SLICES
    rows, cols = ROWS // groups, W // CHAIN_SLICES
    floats = 2 * rows * W + CHAIN_WARPS * rows * cols
    return ChainPlan(CHAIN_CLUSTER, groups, CHAIN_SLICES, rows, cols, CHAIN_WARPS,
                     32 * CHAIN_WARPS, 4 * floats, n_chains * CHAIN_CLUSTER)


def chain_cta(plan: ChainPlan, block: int) -> dict:
    """What CTA ``block`` of the plan's grid holds and does, by the
    kernel's index arithmetic: its chain and cluster rank, its rows and
    columns of the chain's h (it computes and writes that tile), the
    cluster ranks its pushes reach, and each warp's K slice."""
    chain, rank = divmod(block, plan.cluster)
    group, slice_ = divmod(rank, plan.col_slices)
    r0, c0 = group * plan.rows, slice_ * plan.cols
    k_slice = W // plan.k_split
    peers = [group * plan.col_slices + s for s in range(plan.col_slices) if s != slice_]
    return {"chain": chain, "rank": rank, "rows": (r0, r0 + plan.rows),
            "cols": (c0, c0 + plan.cols), "peers": peers,
            "k_slices": [(q * k_slice, (q + 1) * k_slice) for q in range(plan.k_split)]}


def _chain_cluster_launch(xs: torch.Tensor, ws: torch.Tensor, n_steps: int, depth: int,
                          upto: str = "all", bf16_dots: bool = False) -> torch.Tensor:
    """One launch of T4's cluster form on CUDA tensors, its bf16-dot
    instantiation with ``bf16_dots``; ``upto`` other than "all" stops every
    dot early (the time split; the result is then not the chain's).
    Uncounted."""
    n = _chain_shapes(xs, ws, depth, False, "clamp", "cluster")
    device = xs.device
    _require(xs, "xs", device)
    _require(ws, "ws", device)
    if n_steps < 1 or depth < 1:
        raise ValueError(f"n_steps and depth must be ≥ 1, got {n_steps} and {depth}")
    out = torch.empty_like(xs)
    lib = _lib()
    err = lib.probes_chain_cluster(xs.data_ptr(), ws.data_ptr(), out.data_ptr(), n, n_steps,
                                   depth, CHAIN_UPTO[upto], int(bf16_dots), _stream(device))
    _check(lib, err, "probes_chain_cluster launch")
    return out


def stream_cta(n_chains: int, block: int) -> dict:
    """What CTA ``block`` of the stream form's grid holds and does, by the
    kernel's index arithmetic: T4's cut (``chain_cta``: its chain, cluster
    rank, tile of h, peers and warps' K slices), plus each warp's ring
    stages (the k-rows [k0, k1) of its K slice each streams a dot), the
    rows of W its Adam updates (T5: a band of 32 × its columns), the ranks
    its column sums go to (the 8 CTAs of its column slice) and those its
    max|y| goes to (T3: every CTA of the chain)."""
    cta = chain_cta(chain_plan(n_chains), block)
    group = cta["rank"] // CHAIN_SLICES
    cta["stages"] = [[(k0 + q * STREAM_CHUNK_K, k0 + (q + 1) * STREAM_CHUNK_K)
                      for q in range(STREAM_STAGES)] for k0, _ in cta["k_slices"]]
    cta["adam_rows"] = (group * STREAM_ADAM_ROWS, (group + 1) * STREAM_ADAM_ROWS)
    cta["sum_ranks"] = [q * CHAIN_SLICES + cta["rank"] % CHAIN_SLICES
                        for q in range(CHAIN_CLUSTER // CHAIN_SLICES)]
    cta["max_ranks"] = list(range(CHAIN_CLUSTER))
    return cta


def _stream_depth(mode: str) -> int:
    return T3_DEPTH if mode == "t3" else N_BUF * DOTS_PER_BUF


def stream_weight(mode: str, chain: int, g: int) -> int:
    """The index, in the stack of (W, W) weights the kernel is given, of the
    weight dot ``g`` (counted over the launch) reads: T3 the chain's weight
    g mod 8; T5 buffer (g mod 25) // 5."""
    d = g % _stream_depth(mode)
    return chain * T3_DEPTH + d if mode == "t3" else d // DOTS_PER_BUF


def stream_schedule(mode: str, n_steps: int, bf16_dots: bool = False) -> list:
    """One CTA's program in the stream form, whole, in the kernel's order
    (every CTA runs the same one): ("issue", g), the warps' copies of dot
    g's chunks; ("dot", g); ("renorm", trip), T3's max exchange and scale;
    ("adam", b, step), T5's column sums and Adam on buffer b; ("arrive",)
    and ("wait",), the halves of a cluster barrier. dot g's copies are each
    warp's 4 stages (fp32) or the CTA's one slot (bf16). The ring holds
    ``STREAM_SLOTS`` dots (fp32 one, bf16 two): dot g + slots's copies go
    out as dot g reads its stages (bf16: once every warp has read its slot),
    except where dot g + slots is in the
    tail's next step, whose copies wait for Adam's cluster barrier; when
    interleaved, the wait after Adam on a buffer comes at the next Adam.
    ``bf16_dots``: the copies stream the weights' bf16 copy, which the CTAs
    first write (("round",)) and Adam rewrites with the weights, so the
    first copies wait for a cluster barrier after the rounding."""
    depth, pending, slots = _stream_depth(mode), False, STREAM_SLOTS[bf16_dots]
    total = n_steps * depth
    ev = [("round",), ("arrive",), ("wait",)] if bf16_dots else []
    ev += [("issue", g) for g in range(min(slots, total))]
    for g in range(total):
        d, step = g % depth, g // depth
        adam = mode != "t3" and (d == depth - 1 if mode == "tail"
                                 else d % DOTS_PER_BUF == DOTS_PER_BUF - 1)
        ev.append(("dot", g))
        if g + slots < total and not (mode == "tail" and (g + slots) // depth != step):
            ev.append(("issue", g + slots))
        if mode == "t3" and d == depth - 1:
            ev.append(("renorm", step))
        if adam:
            if pending:
                ev.append(("wait",))
            bufs = range(N_BUF) if mode == "tail" else [d // DOTS_PER_BUF]
            ev += [("adam", b, step) for b in bufs] + [("arrive",)]
            if mode == "tail":
                ev.append(("wait",))
                ev += [("issue", q) for q in range(g + 1, min(g + slots, total - 1) + 1)]
            pending = mode == "interleaved"
    return ev + ([("wait",)] if pending else [])


def _stream_launch(mode: str, x: torch.Tensor, w: torch.Tensor, m: Optional[torch.Tensor],
                   v: Optional[torch.Tensor], n_steps: int, t0: int = 0,
                   upto: str = "all", bf16_dots: bool = False) -> torch.Tensor:
    """One launch of the stream form on CUDA tensors: ``mode`` "t3" (x
    (chains, ROWS, W), w (chains, 8·W, W)) or T5's "tail" or "interleaved"
    (x (1, ROWS, W); w, m and v (N_BUF, W, W), updated in place); returns
    the final h. ``bf16_dots`` launches the bf16-dot instantiation. ``upto``
    other than "all" stops every dot early (the time split; the result is
    then not the chain's). Uncounted."""
    device = x.device
    for t, name in ((x, "x"), (w, "w"), (m, "m"), (v, "v")):
        if t is None:  # T3 has no moments; the library refuses T5 without them
            continue
        _require(t, name, device)
        if t.data_ptr() % 16:  # float4 loads; the tensor map wants 16-byte alignment
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if n_steps < 1:
        raise ValueError(f"n_steps must be ≥ 1, got {n_steps}")
    out = torch.empty_like(x)
    # bf16: the launch rounds w into this copy and streams it
    wb = torch.empty(w.shape, dtype=torch.bfloat16, device=device) if bf16_dots else None
    lib = _lib()
    err = lib.probes_chain_stream(x.data_ptr(), w.data_ptr(),
                                  None if wb is None else wb.data_ptr(),
                                  None if m is None else m.data_ptr(),
                                  None if v is None else v.data_ptr(), out.data_ptr(),
                                  x.shape[0], n_steps, STREAM_MODES[mode], t0,
                                  STREAM_UPTO[upto], int(bf16_dots), _stream(device))
    _check(lib, err, f"probes_chain_stream ({mode}) launch")
    return out


def _dot(h: torch.Tensor, w: torch.Tensor, bf16_dots: bool) -> torch.Tensor:
    """h·w in float32; with ``bf16_dots`` of both operands rounded to
    bfloat16 first (their products are exact in float32)."""
    if bf16_dots:
        h, w = bf16_round(h), bf16_round(w)
    return torch.matmul(h, w)


def plain_chain_chunk(xs: torch.Tensor, ws: torch.Tensor, *, n_steps: int, depth: int,
                      weights_per_depth: bool, epilogue: str,
                      bf16_dots: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``chain_chunk`` (every form): the
    tools' loops, one batched ``torch.matmul`` a dot over the chains, of
    bf16-rounded operands with ``bf16_dots``."""
    h = xs.clone()
    for _ in range(n_steps):
        for d in range(depth):
            h = _dot(h, ws[:, d * W:(d + 1) * W] if weights_per_depth else ws, bf16_dots)
            if epilogue == "clamp":
                h = torch.clamp(h, max=CLAMP)
        if epilogue == "renorm":
            top = h.abs().amax(dim=(1, 2), keepdim=True)
            h = h * (1.0 / torch.clamp(top, min=1e-6))
    return h


def _adam_shapes(x, ws, ms, vs) -> None:
    if tuple(x.shape) != (ROWS, W):
        raise ValueError(f"x must be ({ROWS}, {W}), got {tuple(x.shape)}")
    for t, name in ((ws, "ws"), (ms, "ms"), (vs, "vs")):
        if tuple(t.shape) != (N_BUF, W, W):
            raise ValueError(f"{name} must be ({N_BUF}, {W}, {W}), got {tuple(t.shape)}")


def adam_overlap_chunk(x: torch.Tensor, ws: torch.Tensor, ms: torch.Tensor, vs: torch.Tensor,
                       *, n_steps: int, interleave: bool, t0: int = 0,
                       form: str = "phase", bf16_dots: bool = False) -> torch.Tensor:
    """T5: ``n_steps`` steps of 25 dependent dots (buffer d of ``ws`` for
    dots 5d..5d+4, min(·, 8) after each) and Adam on every buffer, the
    gradient of buffer d being the column mean of h broadcast down the rows
    ·1e-6(d + 1), at lr ADAM_LR. ``interleave`` False: every Adam after the
    25th dot (from the final h); True: buffer d's after dot 5d+4 (from h
    there). ``ws``, ``ms`` and ``vs`` (N_BUF, W, W) are updated in place;
    returns h. Adam's t is t0 + step + 1. ``form`` "phase" or "stream"
    (``T5_FORMS``). ``bf16_dots``: every dot of bf16-rounded operands (the
    buffers' current f32 values rounded) with f32 sums; Adam stays f32."""
    _adam_shapes(x, ws, ms, vs)
    if form not in T5_FORMS:
        raise ValueError(f"form must be one of {T5_FORMS}, got {form!r}")
    kw = dict(n_steps=n_steps, interleave=interleave, t0=t0, bf16_dots=bf16_dots)
    if x.device.type == "cpu":
        return plain_adam_overlap_chunk(x, ws, ms, vs, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"adam_overlap_chunk takes CPU or CUDA tensors, got {x.device}")
    device = x.device
    for t, name in ((x, "x"), (ws, "ws"), (ms, "ms"), (vs, "vs")):
        _require(t, name, device)
    if n_steps < 1:
        raise ValueError(f"n_steps must be ≥ 1, got {n_steps}")
    if form == "stream":
        h = _stream_launch("interleaved" if interleave else "tail", x.reshape(1, ROWS, W), ws,
                           ms, vs, n_steps, t0, bf16_dots=bf16_dots)
        _count(adam_overlap_chunk, "stream_launches", bf16_dots)
        return h[0]
    h = _phase_launch(x.reshape(1, ROWS, W), ws, n_steps, N_BUF * DOTS_PER_BUF, False, "clamp",
                      2 if interleave else 1, ms, vs, t0, bf16_dots=bf16_dots)
    _count(adam_overlap_chunk, "launches", bf16_dots)
    return h[0]


adam_overlap_chunk.launches = adam_overlap_chunk.bf16_launches = 0
adam_overlap_chunk.stream_launches = adam_overlap_chunk.bf16_stream_launches = 0


def plain_adam_overlap_chunk(x: torch.Tensor, ws: torch.Tensor, ms: torch.Tensor,
                             vs: torch.Tensor, *, n_steps: int, interleave: bool,
                             t0: int = 0, bf16_dots: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``adam_overlap_chunk``, in place; with
    ``bf16_dots`` each dot rounds h and the buffer's current f32 values to
    bfloat16. The bias corrections 1 − βᵗ are taken in double and rounded
    to float32, as the kernel (and ``csrc/mlp_vae.cu``) does; the tool
    takes exp(t·log β) in float32."""
    f32 = np.float32

    def adam_(d, h, bc1, bc2):
        g = h.mean(dim=0).expand(W, W) * float(f32(1e-6 * (d + 1)))
        ms[d].copy_(B1 * ms[d] + (1.0 - B1) * g)
        vs[d].copy_(B2 * vs[d] + (1.0 - B2) * g * g)
        bc2_sqrt = np.sqrt(bc2)
        lr_t = f32(ADAM_LR) * bc2_sqrt / bc1
        ws[d].sub_(float(lr_t) * ms[d] / (vs[d].sqrt() + float(f32(EPS) * bc2_sqrt)))

    h = x.clone()
    for it in range(n_steps):
        t = t0 + it + 1
        bc1, bc2 = f32(1.0 - 0.9 ** t), f32(1.0 - 0.999 ** t)
        for d in range(N_BUF):
            for _ in range(DOTS_PER_BUF):
                h = torch.clamp(_dot(h, ws[d], bf16_dots), max=CLAMP)
            if interleave:
                adam_(d, h, bc1, bc2)
        if not interleave:
            for d in range(N_BUF):
                adam_(d, h, bc1, bc2)
    return h


@dataclasses.dataclass(frozen=True)
class DotPlan:
    """T2's launch: ``tile_m`` × ``tile_n`` output tiles, K staged
    ``chunk_k`` at a time and cut into ``split`` slices, one cluster of
    ``cluster`` (= split) CTAs a tile, grid (``grid_x``, ``grid_y``) =
    (split · tiles along N, tiles along M), ``smem`` bytes of dynamic shared
    memory and ``threads`` threads a CTA."""
    tile_m: int
    tile_n: int
    chunk_k: int
    split: int
    cluster: int
    grid_x: int
    grid_y: int
    smem: int
    threads: int


def _check_dot_shape(M: int, K: int, N: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if min(M, K, N) < 1 or M % 16 or N % 8 or K % 16:
        raise ValueError(f"M must be a multiple of 16, N of 8 and K of 16, got {M}, {N}, {K}")


def dot_plan(M: int, K: int, N: int, mode: str) -> DotPlan:
    """The plan of T2's kernel for x (M, K) · w (K, N) in ``mode``; the same
    integer arithmetic as ``dot_plan`` in csrc/probes.cu, which checks the
    plan it is given against its own. The split is the largest power of two
    ≤ 8 that gives every slice at least one 16-element unit of K and keeps
    the CTAs at or under 132. Raises outside the contract (M a multiple of
    16, N of 8, K of 16) or past the grid's limits."""
    _check_dot_shape(M, K, N, mode)
    units = K // DOT_UNIT_K
    tiles_m = -(-M // DOT_TILE_M)
    tiles_n = -(-N // DOT_TILE_N)
    if tiles_m > 65535:
        raise ValueError(f"M {M} needs {tiles_m} tiles along M, past the grid's 65535")
    split = DOT_MAX_SPLIT
    while split > 1 and (split > units or tiles_m * tiles_n * split > DOT_MAX_BLOCKS):
        split //= 2
    if tiles_n * split > 2**31 - 1:
        raise ValueError(f"N {N} needs {tiles_n * split} CTAs along x, past the grid's limit")
    smem = (DOT_TILE_M * DOT_RAW_STRIDE + DOT_CHUNK_K * DOT_TILE_N) * 4 + DOT_TILE_M * DOT_P_STRIDE * 4
    if mode != "fp32":  # the operands rounded, in wgmma's layout
        smem += (DOT_TILE_M + DOT_TILE_N) * DOT_CHUNK_K * (2 if mode == "bf16" else 4)
    return DotPlan(DOT_TILE_M, DOT_TILE_N, DOT_CHUNK_K, split, split, tiles_n * split, tiles_m,
                   smem, DOT_THREADS)


def dot_slice(K: int, split: int, rank: int) -> Tuple[int, int]:
    """[k0, k1): the K slice of cluster rank ``rank`` (the kernel's
    arithmetic): whole 16-element units, the first units % split ranks one
    unit longer."""
    units = K // DOT_UNIT_K
    base, extra = divmod(units, split)
    k0 = DOT_UNIT_K * (rank * base + min(rank, extra))
    return k0, k0 + DOT_UNIT_K * (base + (rank < extra))


def dot_block(plan: DotPlan, M: int, K: int, N: int, bx: int, by: int) -> dict:
    """What CTA (bx, by) of the plan's grid covers, by the kernel's index
    arithmetic: its cluster rank, its tile's rows and columns (clipped to M
    and N), its K slice, and the rows of the tile whose sum over the
    cluster it writes to out."""
    rank, tile_n = bx % plan.split, bx // plan.split
    m0, n0 = by * plan.tile_m, tile_n * plan.tile_n
    rows = plan.tile_m // plan.split
    return {"rank": rank, "rows": (m0, min(M, m0 + plan.tile_m)),
            "cols": (n0, min(N, n0 + plan.tile_n)), "k": dot_slice(K, plan.split, rank),
            "sums_rows": (min(M, m0 + rank * rows), min(M, m0 + (rank + 1) * rows))}


def library_dot_plan(M: int, K: int, N: int, mode: str) -> DotPlan:
    """The library's own plan (``probes_dot_plan``), to hold ``dot_plan`` to it."""
    _check_dot_shape(M, K, N, mode)
    lib = _lib()
    out = (ctypes.c_int * 9)()
    _check(lib, lib.probes_dot_plan(M, K, N, MODES[mode], out), "probes_dot_plan")
    return DotPlan(*out)


def _dot_launch(x: torch.Tensor, w: torch.Tensor, mode: str, upto: str = "all") -> torch.Tensor:
    """One launch of T2's kernel on CUDA tensors; ``upto`` other than "all"
    stops it early (the time split; the output is then not written).
    Uncounted."""
    (M, K), N = x.shape, w.shape[1]
    plan = dot_plan(M, K, N, mode)
    device = x.device
    _require(x, "x", device)
    _require(w, "w", device)
    if x.data_ptr() % 16 or w.data_ptr() % 16:  # the kernel copies 16 bytes at a time
        raise ValueError("x and w must start on a 16-byte boundary")
    out = torch.empty(M, N, dtype=torch.float32, device=device)
    lib = _lib()
    err = lib.probes_dot(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, MODES[mode],
                         plan.split, plan.grid_x, plan.grid_y, plan.smem, DOT_UPTO[upto],
                         _stream(device))
    _check(lib, err, f"probes_dot ({mode}) launch")
    return out


def dot_modes(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """T2: x (M, K) · w (K, N) with fp32 FMAs ("fp32"), or on the tensor
    cores with operands rounded to TF32 ("tf32", nearest, ties away) or to
    bfloat16 ("bf16", nearest even), summed in float32. M a multiple of 16,
    N of 8, K of 16."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x (M, K) and w (K, N) expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return plain_dot_modes(x, w, mode)
    if x.device.type != "cuda":
        raise ValueError(f"dot_modes takes CPU or CUDA tensors, got {x.device}")
    out = _dot_launch(x, w, mode)
    dot_modes.launches += 1
    return out


dot_modes.launches = 0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits; ties away from
    zero, as ``cvt.rna.tf32.f32``), on the float's bits; non-finite values
    pass through."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), (mag | sign).view(torch.float32), x)


def plain_dot_modes(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """The plain PyTorch version of ``dot_modes``: the operands rounded as
    the mode rounds them, then a float32 ``torch.matmul`` (products of TF32
    or bfloat16 values are exact in float32; only the order of the sums
    differs from the kernel's)."""
    if mode == "tf32":
        x, w = round_tf32(x), round_tf32(w)
    elif mode == "bf16":
        x, w = x.bfloat16().float(), w.bfloat16().float()
    return torch.matmul(x, w)
