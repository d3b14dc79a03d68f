"""K1, K2 and K6a: the fused linear-VAE training chunk — CUDA wrappers and
plain versions.

Port of ``vae_training_tpu/kernels/linear_vae.py`` (``run_fused_chunk`` →
``_make_kernel``, the ``pl.pallas_call`` at ``:678``), in its two branches:
K1 on the linear_gaussian dataset, and K2 on the sigmoid dataset with the
dual decoder ``σ(s·Ws + bs) + s·Wd + bd`` (``dual=True``); in solo mode and
in grid mode (K6a, ``grid_n > 0``: many sweep rows, of mixed dims, in one
launch). The kernel itself is ``csrc/linear_vae.cu``: one launch runs a
whole K-step chunk (sampling, forward, closed-form ELBO, analytic backward,
Adam) with each row's state resident in one CTA's shared memory.

The state crosses the launch as three flat float32 buffers (params, Adam
m, Adam v) in the layout of ``param_layout``: flax names, true dimensions,
no TPU lane padding. The dual layout is K1's followed by the SigDecoder's
two tensors, so K1's buffers are unchanged. ``run_fused_chunk`` updates
them in place and returns the per-step losses.

``adam_dtype="bf16"`` (``--adam_dtype bf16``) is K4, the bf16 branch of the
TPU kernels' ``_adam`` (``linear_vae.py:188-218``): the kernel rounds each
weight matrix's m and v to bfloat16 at every step (``train/state.py``'s
rule). The flat buffers stay float32 and hold those bfloat16 values
exactly, so packing a state's bf16 moments is exact, and so is copying the
buffers back into them.

``bf16_dots`` (``--precision bf16`` on the card, ``config.bf16_dots``) is
the TPU kernels' default dot mode (``prec = None``, ``linear_vae.py:324-
345``): every dot of the step (the manifold draw, the forward, the three
gradient products) takes bfloat16 operands, round to nearest even, and sums
in f32; the biases, the bias gradients, the ELBO, g_ep's column sums and
Adam stay f32. It is a launch-wide flag of every kernel (K1, K2, K6a) and a
flag of the plain versions, which build the model and the dataset with it.
The kernel's bf16-dot instantiation runs the products on the tensor cores
(``mma.sync`` m16n8k16) with its own shared-memory plan (``bf16_plan``)
and warp roles (``warp_roles``), both mirrored here.

``run_fused_chunk`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors (and only for them) it runs ``plain_fused_chunk``,
the same chunk on the torch path (``train/step.py``) behind the same
signature, whose autograd backward checks the kernel's hand-derived one.
``run_fused_chunk.launches`` counts kernel launches.

``run_grid_chunk`` is K6a's wrapper: the rows' states concatenated in three
flat buffers (``pack_rows``; row i at ``row_offsets(...)[i]``), one
``GridRow`` of dims, manifold and seeds per row, one launch of one CTA per
row. For CPU tensors it runs ``plain_grid_chunk``, one ``plain_fused_chunk``
per row; ``run_grid_chunk.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import rng
from ..train.state import TrainState, moment_dtype
from ..train.step import Noise, train_chunk as torch_train_chunk
from ..utils.spans import span

THREADS = 1024  # the kernel's CTA size (kThreads in csrc/linear_vae.cu)
SAMPLER_MAX_CALLS = 2**31 - 1  # Philox calls a draw (the kernel's 32-bit index)
# timing variants of a launch (kSkip* in csrc/linear_vae.cu; 0 in training)
SKIP = {"noise": 1, "rows": 2, "params": 4, "work": 8}
HEADER = 128  # floats of the launch header (kHeader)
BC_STEPS = 256  # steps of the bias-correction table (kBcSteps)
# Dynamic shared memory a block may opt into on sm_90 (227 KB).
SMEM_LIMIT = 232448
# bf16 dots: the most warps a phase gives the tensor-core passes (kMaxRowWarps,
# kMaxTileWarps, kMaxPoolWarps); the rest draw the next step's noise
MAX_ROW_WARPS, MAX_TILE_WARPS, MAX_POOL_WARPS = 24, 22, 7
TILE_M, TILE_N, KSTEP = 16, 8, 16  # mma.sync m16n8k16
# compute capability the kernel is built for (sm_90a)
CAPABILITY = (9, 0)


Layout = List[Tuple[str, tuple]]


def param_layout(data_dim: int, latent_dim: int, dual: bool = False) -> Layout:
    """Flat order of the state buffers (csrc/linear_vae.cu agrees). The
    ``epsilon`` slot is always present; without -tdv its gradient is zero,
    so Adam leaves it unchanged and unpacking ignores it. The dual decoder's
    ``SigDecoder`` tensors follow K1's layout."""
    D, L = data_dim, latent_dim
    layout = [("Encoder.FC0.kernel", (D, L)), ("Encoder.FC0.bias", (L,)),
              ("Decoder.FC0.kernel", (L, D)), ("Decoder.FC0.bias", (D,)),
              ("epsilon_p", (L,)), ("epsilon", (1,))]
    if dual:
        layout += [("SigDecoder.FC0.kernel", (L, D)), ("SigDecoder.FC0.bias", (D,))]
    return layout


def n_params(data_dim: int, latent_dim: int, dual: bool = False) -> int:
    D, L = data_dim, latent_dim
    return 2 * D * L + 2 * L + D + 1 + (L * D + D if dual else 0)


def _quad(n: int) -> int:
    return (n + 3) & ~3


def _stride(n: int) -> int:
    """A row stride of at least n floats that is an odd multiple of 4
    (``stride`` in the .cu file)."""
    return _quad(n) + (0 if _quad(n) & 4 else 4)


def _slabs(n: int) -> int:
    return (n + KSTEP - 1) // KSTEP


def _oct(n: int) -> int:
    return (n + 7) & ~7


def _halves(n: int) -> int:
    """Floats holding n bfloat16 values, a multiple of 4."""
    return _quad((n + 1) // 2)


def bf16_plan(batch: int, data_dim: int, latent_dim: int) -> dict:
    """The bf16-dot mode's strides (``plan_bf16`` in the .cu file): the
    batch padded to the tiles' 16 rows (``bp``); the f32 rows of x, g_y and
    g_u (``ldx``, ``ldg``: the contraction's k16 steps + 4) and of mu→g_mu
    (``ldm``: L padded to 8, + 4); g_s·z1's (``ldq``, the pool's only, B
    rows); the weights' bfloat16 copies
    along j (``ldwd``: WeT, Wd, Ws) and along l (``ldwl``: WdT, WsT), k16
    steps + 8; s, bfloat16 only (``ldal``: k16 steps + 4). bfloat16
    strides count bfloat16 values."""
    kd, kl = _slabs(data_dim), _slabs(latent_dim)
    return {"bp": KSTEP * ((batch + KSTEP - 1) // KSTEP), "ldx": KSTEP * kd + 4,
            "ldg": KSTEP * kd + 4, "ldm": _oct(latent_dim) + 4, "ldq": _quad(latent_dim),
            "ldwd": KSTEP * kd + 8,
            "ldwl": KSTEP * kl + 8, "ldal": KSTEP * kl + 4}


def mat_tiles(data_dim: int, latent_dim: int, dual: bool = False) -> List[Tuple[str, int, int]]:
    """bf16 dots: the per-parameter pass's (m16, n8) gradient tiles in the
    kernel's order (``param_pass_tc``): (matrix, m0, n0) of g_We (rows j,
    columns l), then g_Wd and, dual, g_Ws (rows l, columns j)."""
    D, L = data_dim, latent_dim
    tiles = [("We", TILE_M * (i // _cdiv(L, TILE_N)), TILE_N * (i % _cdiv(L, TILE_N)))
             for i in range(_slabs(D) * _cdiv(L, TILE_N))]
    for name in ("Wd", "Ws") if dual else ("Wd",):
        tiles += [(name, TILE_M * (i // _cdiv(D, TILE_N)), TILE_N * (i % _cdiv(D, TILE_N)))
                  for i in range(_slabs(L) * _cdiv(D, TILE_N))]
    return tiles


def pool_tiles(data_dim: int, latent_dim: int, dual: bool = False) -> List[Tuple[str, int]]:
    """bf16 dots: the f32 pool's tiles of 4 columns (``pool_pass``): (slot,
    c0) of the bias rows be, bd, (dual) bs and of ep."""
    D, L = data_dim, latent_dim
    names = [("be", L), ("bd", D)] + ([("bs", D)] if dual else []) + [("ep", L)]
    return [(name, c0) for name, n in names for c0 in range(0, n, 4)]


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b



def warp_roles(batch: int, data_dim: int, latent_dim: int, intrinsic_dim: int,
               dual: bool = False, obs: bool = False) -> dict:
    """bf16 dots: the CTA's warps in each phase (``roles`` in the .cu
    file). Phase A: ``rw`` row warps; phase B: ``tw`` tile warps, one a
    gradient tile, then ``pw`` pool warps (4 teams of 8 lanes each); the
    warps after them in each phase draw the
    next step's noise. ``z2a``: z2's draws join phase A's draw when that
    takes fewer rounds of Philox calls a lane over the two phases. A row
    warp takes one 16 × 8 output tile of a stage at a time: ``rw`` is the
    largest stage's count (16-row blocks × 8-column tiles), capped."""
    B, D, L = batch, data_dim, latent_dim
    rw = min(_cdiv(B, TILE_M) * _cdiv(max(D, L), TILE_N), MAX_ROW_WARPS)
    tw = min(len(mat_tiles(D, L, dual)), MAX_TILE_WARPS)
    pw = min(_cdiv(len(pool_tiles(D, L, dual)), 4), MAX_POOL_WARPS)
    lanes_a, lanes_b = THREADS - 32 * rw, THREADS - 32 * (tw + pw)
    calls_a = B * (_cdiv(intrinsic_dim, 4) + (_cdiv(D, 4) if obs else 0) + _cdiv(L, 4))
    calls_z2 = B * _cdiv(D, 4)
    z2a = _cdiv(calls_a + calls_z2, lanes_a) < _cdiv(calls_a, lanes_a) + _cdiv(calls_z2, lanes_b)
    return {"rw": rw, "tw": tw, "pw": pw, "z2a": z2a}


def smem_bytes(batch: int, data_dim: int, latent_dim: int, intrinsic_dim: int,
               manifold_dim: int, dual: bool = False, bf16_dots: bool = False) -> int:
    """Shared memory of one row (mirrors ``plan`` in the .cu file, buffer by
    buffer): the launch header; params, m and v; the manifold matrix (A, or
    the sigmoid's column a); e^{ep/2}; a 4-float slot for the KL constant;
    the bias corrections of 256 steps; the weights' padded copies (WeT, Wd,
    WdT and, dual, Ws, WsT); the double-buffered noise (x with its column
    of ones, z1, z2); the intrinsic normals; s with its column of ones, g_y,
    (dual) g_u, g_mu, g_s·z1 and the rows' partial sums. ``bf16_dots``:
    the bf16-dot mode's plan (``plan_bf16``): the same buffers, the copies
    and s as bfloat16 without the bias and ones columns, x, s, g_y, g_u and
    g_mu over the batch padded to 16 rows (``bf16_plan``'s strides), and
    the row partials a tile."""
    D, L, B = data_dim, latent_dim, batch
    P = n_params(D, L, dual)
    if bf16_dots:
        t = bf16_plan(B, D, L)
        bp = t["bp"]
        copies = (2 * _halves(_oct(L) * t["ldwd"]) + _halves(_oct(D) * t["ldwl"])
                  + (_halves(_oct(L) * t["ldwd"]) + _halves(_oct(D) * t["ldwl"]) if dual else 0))
        floats = (HEADER + 3 * _quad(P)
                  + _quad(manifold_dim if dual else manifold_dim * intrinsic_dim)
                  + _quad(L) + 4 + 2 * BC_STEPS + copies
                  + 2 * (bp * t["ldx"] + _quad(B * L) + _quad(B * D))
                  + _quad(B * intrinsic_dim) + _halves(bp * t["ldal"])
                  + bp * t["ldg"] * (2 if dual else 1) + bp * t["ldm"] + B * t["ldq"]
                  + _quad(B * (_cdiv(L, TILE_N) + 2 * _cdiv(D, TILE_N))))
        return 4 * floats
    ldx, lds, ldg, ldm = _stride(D + 1), _stride(L + 1), _stride(D), _quad(L)
    copies = L * ldx + (L * ldg + D * lds) * (2 if dual else 1)
    floats = (HEADER + 3 * _quad(P)
              + _quad(manifold_dim if dual else manifold_dim * intrinsic_dim)
              + _quad(L) + 4 + 2 * BC_STEPS + copies
              + 2 * (B * ldx + _quad(B * L) + _quad(B * D))
              + _quad(B * intrinsic_dim) + B * lds + B * ldg * (2 if dual else 1)
              + 2 * B * ldm + _quad(3 * B))
    return 4 * floats


def pack_layout(tensors, layout: Layout) -> torch.Tensor:
    """Dict of named tensors → one flat float32 buffer in ``layout``'s
    order (bf16 moments cast exactly); a slot missing from the dict
    (epsilon without -tdv) is zero."""
    parts = []
    for name, shape in layout:
        t = tensors.get(name)
        if t is None:
            ref = next(iter(tensors.values()))
            t = torch.zeros(shape, dtype=torch.float32, device=ref.device)
        parts.append(t.reshape(-1).to(torch.float32))
    return torch.cat(parts).contiguous()


def unpack_layout_(flat: torch.Tensor, tensors, layout: Layout) -> None:
    """Copy a flat buffer into the named tensors present, in place. A bf16
    tensor takes its slot's values exactly when the kernel rounded them."""
    off = 0
    for name, shape in layout:
        n = int(np.prod(shape))
        if name in tensors:
            tensors[name].copy_(flat[off:off + n].view(shape))
        off += n


def repack_layout_(flat: torch.Tensor, tensors, layout: Layout) -> None:
    """Copy the named tensors present into a flat buffer, in place; the
    slots of absent names keep their values."""
    off = 0
    for name, shape in layout:
        n = int(np.prod(shape))
        if name in tensors:
            flat[off:off + n].copy_(tensors[name].reshape(-1))
        off += n


def pack(tensors, data_dim: int, latent_dim: int, dual: bool = False) -> torch.Tensor:
    """Dict of named tensors → one flat (P,) float32 buffer."""
    return pack_layout(tensors, param_layout(data_dim, latent_dim, dual))


def unpack_(flat: torch.Tensor, tensors, data_dim: int, latent_dim: int,
            dual: bool = False) -> None:
    """Copy a flat buffer back into the named tensors, in place."""
    unpack_layout_(flat, tensors, param_layout(data_dim, latent_dim, dual))


def pack_state(state: TrainState, data_dim: int, latent_dim: int, dual: bool = False):
    return tuple(pack(d, data_dim, latent_dim, dual)
                 for d in (state.params, state.m, state.v))


def unpack_state(state: TrainState, p, m, v, n_steps: int, data_dim: int,
                 latent_dim: int, dual: bool = False) -> TrainState:
    for flat, d in ((p, state.params), (m, state.m), (v, state.v)):
        unpack_(flat, d, data_dim, latent_dim, dual)
    state.step += n_steps
    state.count += n_steps
    return state


def moments_bf16(adam_dtype: str) -> bool:
    """The kernels' launch-wide flag: whether a weight matrix's moments are
    bfloat16 under ``adam_dtype`` (``moment_dtype``'s rule)."""
    return moment_dtype((1, 1), adam_dtype) == torch.bfloat16


def matrix_mask(layout: Layout) -> torch.Tensor:
    """(P,) bool: the flat slots whose moments are bfloat16 under
    ``--adam_dtype bf16`` (``moment_dtype``'s rule: the weight matrices)."""
    return torch.cat([torch.full((int(np.prod(shape)),),
                                 moment_dtype(shape, "bf16") == torch.bfloat16)
                      for _, shape in layout])


def cuda_device_ok(cfg) -> Tuple[bool, str]:
    """Whether ``cfg.device`` is a CUDA device of compute capability 9.0,
    the one the kernels are built for (sm_90a)."""
    device = torch.device(cfg.device)
    if device.type != "cuda":
        return False, f"device {cfg.device!r} is not a CUDA device"
    if not torch.cuda.is_available():
        return False, "no CUDA device is available"
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != CAPABILITY:
        return False, f"the kernels are built for sm_90a; this device is sm_{cap[0]}{cap[1]}"
    return True, ""


def _structure(model, dataset, batch: int) -> Tuple[bool, str]:
    """The model and dataset part of ``supported``: which branch, and
    whether one row fits a block's shared memory. Returns (ok, reason)."""
    from ..data.synthetic import LinearGaussianDataset, SigmoidDataset

    dual = model.dual_sigmoid_decoder
    if isinstance(dataset, LinearGaussianDataset):
        if dual:
            return False, "the dual decoder needs the sigmoid dataset"
    elif isinstance(dataset, SigmoidDataset):
        if not dual:
            return False, "the sigmoid dataset expects the dual decoder"
    else:
        return False, "the fused kernel supports the linear_gaussian and sigmoid datasets"
    if (model.encoder_features != (model.latent_dim,)
            or model.decoder_features != (dataset.dimension,)):
        return False, "the fused kernel supports 0-hidden-layer (pure linear) nets"
    need = smem_bytes(batch, dataset.dimension, model.latent_dim,
                      dataset.intrinsic_dim, dataset.dim, dual, getattr(model, "bf16_dots", False))
    if need > SMEM_LIMIT:
        return False, (f"state and activations need {need} B of shared memory, "
                       f"above the {SMEM_LIMIT} B a block may use")
    return True, f"{need} B of shared memory"


def supported(model, dataset, cfg) -> Tuple[bool, str]:
    """Whether K1 or K2 can run this configuration (the counterpart of
    ``pallas_supported``, ``linear_vae.py:823-858``, re-derived for the
    card): a pure-linear encoder and decoder; the linear_gaussian dataset
    without the dual decoder (K1) or the sigmoid dataset with it (K2); a
    CUDA device of compute capability 9.0; and a state plus per-step
    activations that fit one block's shared memory. The TPU kernel's
    batch ≤ 128 and dims ≤ 128 were lane limits and do not apply."""
    ok, why = _structure(model, dataset, cfg.batch_size)
    if not ok:
        return False, why
    ok, why_dev = cuda_device_ok(cfg)
    if not ok:
        return False, why_dev
    if model.dual_sigmoid_decoder:
        return True, f"pure-linear dual-decoder VAE on sigmoid, {why}"
    return True, f"pure-linear VAE on linear_gaussian, {why}"


def grid_supported(models: Sequence, datasets: Sequence, cfg) -> Tuple[bool, str]:
    """Whether K6a can run these rows in one launch (the grid counterpart
    of ``supported``; the uniformity rules of the JAX package's
    ``_rows_uniform`` / ``mixed_launch_eligible``, ``mixed_grid.py:42-113``).
    ``models``, ``datasets`` and ``cfg`` give one row each (``cfg`` may be
    one config for all rows). Every row must pass ``supported``'s model and
    shared-memory checks; the rows may differ only in their dims and seeds:
    batch, learning rate, ε, -tdv, the decoder head, the dataset kind and
    its observation noise, and the step count and the print and plot
    cadences (so every row shares every chunk boundary) are uniform. The
    device is a CUDA device of compute capability 9.0, or the CPU, where
    ``run_grid_chunk`` runs the plain version. The Adam moment dtype
    (``--adam_dtype``) and ``--precision`` (the dot mode, with the model's
    resolved ``bf16_dots``) are uniform too: the kernel's flags are the
    launch's. A refusal names the first row that fails."""
    cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else [cfg] * len(models)
    if not models or not len(models) == len(datasets) == len(cfgs):
        return False, (f"need one model, dataset and config a row, got {len(models)}, "
                       f"{len(datasets)} and {len(cfgs)}")

    def uniform(model, dataset, c):
        return {"batch size": c.batch_size, "learning rate": float(c.learning_rate),
                "adam_dtype": c.adam_dtype,
                "precision": (getattr(c, "precision", "bf16"), getattr(model, "bf16_dots", False)),
                "epsilon": model.epsilon_const, "-tdv": model.tunable_decoder_var,
                "decoder head": model.dual_sigmoid_decoder,
                "dataset": type(dataset).__name__,
                "observation noise": float(dataset.var_added),
                "num_batches": c.num_batches, "n_print": c.n_print, "n_plot": c.n_plot,
                "device": str(c.device)}

    ref = uniform(models[0], datasets[0], cfgs[0])
    need = []
    for i, (model, dataset, c) in enumerate(zip(models, datasets, cfgs)):
        for key, val in uniform(model, dataset, c).items():
            if val != ref[key]:
                return False, (f"row {i} differs from row 0 in {key} ({val!r} vs "
                               f"{ref[key]!r}); one launch takes rows that differ "
                               f"only in dims and seeds")
        ok, why = _structure(model, dataset, c.batch_size)
        if not ok:
            return False, f"row {i}: {why}"
        need.append(smem_bytes(c.batch_size, dataset.dimension, model.latent_dim,
                               dataset.intrinsic_dim, dataset.dim, model.dual_sigmoid_decoder,
                               getattr(model, "bf16_dots", False)))
    if torch.device(cfgs[0].device).type != "cpu":
        ok, why = cuda_device_ok(cfgs[0])
        if not ok:
            return False, why
    head = "dual-decoder VAE on sigmoid" if models[0].dual_sigmoid_decoder else \
        "VAE on linear_gaussian"
    return True, (f"{len(models)} pure-linear {head} rows, up to {max(need)} B of "
                  f"shared memory a block")


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ._build import load_library

        lib = load_library("linear_vae")[0]
        vp, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.linear_vae_chunk.argtypes = (
            [vp] * 8 + [i32] * 7 + [u32, i32, u32, u32, u32, u32, f32, f32, i32, f32, i32, i32,
                                    vp])
        lib.linear_vae_chunk.restype = i32
        lib.philox_draw.argtypes = [vp, vp, i32, i32, u32, u32, u32, u32, vp]
        lib.philox_draw.restype = i32
        lib.linear_vae_smem_bytes.argtypes = [i32] * 7
        lib.linear_vae_smem_bytes.restype = ctypes.c_size_t
        lib.linear_vae_error_string.argtypes = [i32]
        lib.linear_vae_error_string.restype = ctypes.c_char_p
        lib.linear_vae_row_bytes.argtypes = []
        lib.linear_vae_row_bytes.restype = ctypes.c_size_t
        lib.linear_vae_grid_chunk.argtypes = [vp, vp] + [i32] * 4 + [f32, i32, f32, i32, i32, i32,
                                                                      vp]
        lib.linear_vae_grid_chunk.restype = i32
        lib.linear_vae_blocks_per_sm.argtypes = [i32, ctypes.c_size_t, ctypes.POINTER(i32)]
        lib.linear_vae_blocks_per_sm.restype = i32
        if lib.linear_vae_row_bytes() != ctypes.sizeof(Row):
            raise RuntimeError(f"csrc/linear_vae.cu's Row is {lib.linear_vae_row_bytes()} B, "
                               f"kernels/linear_vae.py's {ctypes.sizeof(Row)} B")
        _LIB = lib
    return _LIB


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.linear_vae_error_string(err).decode()})")


def _require(t: torch.Tensor, name: str, device, shape=None) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def run_fused_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    a: torch.Tensor, *, n_steps: int, batch: int, data_dim: int,
                    latent_dim: int, intrinsic_dim: int, manifold_dim: int,
                    step0: int, t0: int, data_seed: int, model_seed: int,
                    var_added: float, eps_const: float, tdv: bool, lr: float,
                    external_noise: Optional[Noise] = None,
                    dual: bool = False, adam_dtype: str = "f32",
                    bf16_dots: bool = False) -> torch.Tensor:
    """Train ``n_steps`` steps from the flat state (p, m, v), in place.
    Returns the (n_steps,) losses. ``a`` is the manifold matrix: A
    (manifold_dim × intrinsic_dim) for linear_gaussian (K1), the sigmoid's
    column a (manifold_dim × 1, with intrinsic_dim = manifold_dim) with
    ``dual`` (K2, no observation noise). ``step0`` is the absolute step of
    the first step (the Philox counter) and ``t0`` the Adam count before
    it. ``external_noise`` = (x, z1, z2), each (n_steps, batch, dim),
    replaces the in-kernel sampler (the test hook of the TPU kernel).
    ``adam_dtype="bf16"`` rounds the weight matrices' moments to bfloat16
    every step (K4); ``bf16_dots`` makes every dot take bfloat16 operands
    and f32 sums."""
    kw = dict(n_steps=n_steps, batch=batch, data_dim=data_dim,
              latent_dim=latent_dim, intrinsic_dim=intrinsic_dim,
              manifold_dim=manifold_dim, step0=step0, t0=t0,
              data_seed=data_seed, model_seed=model_seed, var_added=var_added,
              eps_const=eps_const, tdv=tdv, lr=lr, external_noise=external_noise,
              dual=dual, adam_dtype=adam_dtype, bf16_dots=bf16_dots)
    if p.device.type == "cpu":
        return plain_fused_chunk(p, m, v, a, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"run_fused_chunk takes CPU or CUDA tensors, got {p.device}")
    D, L, B = data_dim, latent_dim, batch
    device = p.device
    P = n_params(D, L, dual)
    bf16 = moments_bf16(adam_dtype)
    for t, name in ((p, "p"), (m, "m"), (v, "v")):
        _require(t, name, device, (P,))
    if dual:
        if intrinsic_dim != manifold_dim or var_added > 0:
            raise ValueError("the sigmoid dataset draws intrinsic_dim = manifold_dim "
                             "normals and has no observation noise")
        _require(a, "a", device, (manifold_dim, 1))
    else:
        _require(a, "a", device, (manifold_dim, intrinsic_dim))
    need = smem_bytes(B, D, L, intrinsic_dim, manifold_dim, dual, bf16_dots)
    if need > SMEM_LIMIT:
        raise ValueError(f"shapes need {need} B of shared memory (limit {SMEM_LIMIT})")
    ext = [None, None, None]
    if external_noise is not None:
        for i, (t, name, dim) in enumerate(zip(external_noise, ("x", "z1", "z2"), (D, L, D))):
            _require(t, f"external_noise {name}", device, (n_steps, B, dim))
            ext[i] = t.data_ptr()
    losses = torch.empty(n_steps, dtype=torch.float32, device=device)
    if n_steps == 0:
        return losses
    lib = _lib()
    dk = rng.key_words(data_seed)
    mk = rng.key_words(model_seed)
    obs_scale = float(np.sqrt(np.float32(var_added))) if var_added > 0 else 0.0
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.linear_vae_chunk(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), losses.data_ptr(), a.data_ptr(),
        *ext, n_steps, B, D, L, intrinsic_dim, manifold_dim, int(dual),
        step0 & rng.MASK32, t0, dk[0], dk[1], mk[0], mk[1], obs_scale,
        float(eps_const), int(bool(tdv)), float(lr), int(bf16), int(bool(bf16_dots)), stream)
    _check(lib, err, "linear_vae_chunk launch")
    run_fused_chunk.launches += 1
    return losses


run_fused_chunk.launches = 0


def run_plain_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, layout: Layout,
                    model, dataset, *, n_steps: int, batch: int, step0: int, t0: int,
                    data_seed: int, model_seed: int, tdv: bool, lr: float,
                    external_noise: Optional[Noise], adam_dtype: str = "f32") -> torch.Tensor:
    """The torch path over flat state buffers, in place: what every plain
    kernel version runs. The moments take ``moment_dtype``'s dtypes, so
    bf16 runs the torch path's bf16 update (K4's plain version). Without
    -tdv the epsilon slot is not a parameter of ``model`` and keeps its
    value."""

    def unflat(flat, adam=None):
        d = {name: torch.empty(shape, device=flat.device, dtype=(
                 torch.float32 if adam is None else moment_dtype(shape, adam)))
             for name, shape in layout if tdv or name != "epsilon"}
        unpack_layout_(flat, d, layout)
        return d

    state = TrainState(params=unflat(p), m=unflat(m, adam_dtype), v=unflat(v, adam_dtype),
                       count=t0, step=step0, data_seed=data_seed, model_seed=model_seed)
    state, losses = torch_train_chunk(model, dataset, state, n_steps,
                                      batch_size=batch, lr=lr,
                                      noise=external_noise)
    for flat, d in ((p, state.params), (m, state.m), (v, state.v)):
        repack_layout_(flat, d, layout)
    return losses


def plain_fused_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      a: torch.Tensor, *, n_steps: int, batch: int, data_dim: int,
                      latent_dim: int, intrinsic_dim: int, manifold_dim: int,
                      step0: int, t0: int, data_seed: int, model_seed: int,
                      var_added: float, eps_const: float, tdv: bool, lr: float,
                      external_noise: Optional[Noise] = None,
                      dual: bool = False, adam_dtype: str = "f32",
                      bf16_dots: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``run_fused_chunk``: the same chunk on
    the torch path (autograd + the explicit Adam update), same signature,
    same in-place contract; the model and the dataset take ``bf16_dots``
    (on the card, fp32 GEMMs of rounded operands)."""
    from ..data.synthetic import LinearGaussianDataset, SigmoidDataset
    from ..models.networks import build_vae

    D, L = data_dim, latent_dim
    model = build_vae(data_dim=D, latent_dim=L, epsilon=eps_const,
                      tunable_decoder_var=tdv,
                      dataset_name="sigmoid" if dual else None, bf16_dots=bf16_dots)
    if dual:
        dataset = SigmoidDataset(a, manifold_dim, D - manifold_dim - 1, bf16_dots)
    else:
        dataset = LinearGaussianDataset(a, manifold_dim, intrinsic_dim,
                                        D - manifold_dim, var_added, bf16_dots)
    return run_plain_chunk(p, m, v, param_layout(D, L, dual), model, dataset,
                           n_steps=n_steps, batch=batch, step0=step0, t0=t0,
                           data_seed=data_seed, model_seed=model_seed, tdv=tdv,
                           lr=lr, external_noise=external_noise, adam_dtype=adam_dtype)


def make_train_chunk(model, dataset, cfg):
    """The Trainer's ``train_chunk(state, n_steps)`` on K1 (K2 with the dual
    decoder), in the dot mode the model was built with."""
    D, L = dataset.dimension, model.latent_dim
    dual = model.dual_sigmoid_decoder
    a = dataset.A.contiguous()
    lr = float(cfg.learning_rate)

    def train_chunk(state: TrainState, n_steps: int, noise: Optional[Noise] = None):
        p, m, v = pack_state(state, D, L, dual)
        losses = run_fused_chunk(
            p, m, v, a, n_steps=n_steps, batch=cfg.batch_size, data_dim=D,
            latent_dim=L, intrinsic_dim=dataset.intrinsic_dim,
            manifold_dim=dataset.dim, step0=state.step, t0=state.count,
            data_seed=state.data_seed, model_seed=state.model_seed,
            var_added=dataset.var_added, eps_const=model.epsilon_const,
            tdv=model.tunable_decoder_var, lr=lr, external_noise=noise, dual=dual,
            adam_dtype=cfg.adam_dtype, bf16_dots=model.bf16_dots)
        return unpack_state(state, p, m, v, n_steps, D, L, dual), losses

    return train_chunk


class Row(ctypes.Structure):
    """One row of K6a's device table: ``struct Row`` in csrc/linear_vae.cu,
    field by field (``_lib`` holds the two to one size)."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("p", "m", "v", "losses", "a", "ext_x", "ext_z1", "ext_z2")] + [
        (name, ctypes.c_int) for name in ("D", "L", "id", "dd")] + [
        ("step0", ctypes.c_uint), ("t0", ctypes.c_int), ("dk0", ctypes.c_uint),
        ("dk1", ctypes.c_uint), ("mk0", ctypes.c_uint), ("mk1", ctypes.c_uint),
        ("obs_scale", ctypes.c_float)]


@dataclass(frozen=True)
class GridRow:
    """One sweep row of a K6a launch: its dims, its manifold matrix ``a``
    (as ``run_fused_chunk`` takes it), its counters and its run seeds."""
    data_dim: int
    latent_dim: int
    intrinsic_dim: int
    manifold_dim: int
    a: torch.Tensor
    step0: int
    t0: int
    data_seed: int
    model_seed: int
    var_added: float = 0.0


def row_offsets(rows: Sequence[GridRow], dual: bool = False) -> List[int]:
    """Start of each row's slice in the packed buffers, and their total
    length last: rows lie back to back in the order given."""
    offs = [0]
    for r in rows:
        offs.append(offs[-1] + n_params(r.data_dim, r.latent_dim, dual))
    return offs


def pack_rows(states: Sequence[TrainState], rows: Sequence[GridRow], dual: bool = False):
    """The rows' states → three flat buffers (params, m, v), row i's flat
    ``pack_state`` at ``row_offsets(rows, dual)[i]``."""
    packed = [pack_state(s, r.data_dim, r.latent_dim, dual) for s, r in zip(states, rows)]
    return tuple(torch.cat([bufs[j] for bufs in packed]) for j in range(3))


def row_views(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, rows: Sequence[GridRow],
              dual: bool = False):
    """Row i's (p, m, v) slices of the packed buffers, as views."""
    offs = row_offsets(rows, dual)
    return [tuple(t[offs[i]:offs[i + 1]] for t in (p, m, v)) for i in range(len(rows))]


def unpack_rows(states: Sequence[TrainState], p: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, rows: Sequence[GridRow], n_steps: int,
                dual: bool = False) -> List[TrainState]:
    """Copy the packed buffers back into each row's state by name and
    advance its counters by ``n_steps``."""
    return [unpack_state(s, *bufs, n_steps, r.data_dim, r.latent_dim, dual)
            for s, bufs, r in zip(states, row_views(p, m, v, rows, dual), rows)]


def run_grid_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                   rows: Sequence[GridRow], *, n_steps: int, batch: int, eps_const: float,
                   tdv: bool, lr: float, dual: bool = False,
                   external_noise: Optional[Sequence[Noise]] = None,
                   adam_dtype: str = "f32", bf16_dots: bool = False) -> torch.Tensor:
    """K6a: train every row ``n_steps`` steps from the packed state
    (``pack_rows``), in place, in one launch of one CTA per row. Returns
    the (rows, n_steps) losses. Row i runs what ``run_fused_chunk`` runs on
    its slice with its ``GridRow``; batch, ε, -tdv, lr, the decoder head,
    the moment dtype and the dot mode are the launch's. ``external_noise``,
    one (x, z1, z2) a row, replaces the in-kernel sampler (the test hook)."""
    kw = dict(n_steps=n_steps, batch=batch, eps_const=eps_const, tdv=tdv, lr=lr, dual=dual,
              external_noise=external_noise, adam_dtype=adam_dtype, bf16_dots=bf16_dots)
    if p.device.type == "cpu":
        return plain_grid_chunk(p, m, v, rows, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"run_grid_chunk takes CPU or CUDA tensors, got {p.device}")
    losses = _grid_launch(p, m, v, rows, **kw)
    if n_steps > 0:
        run_grid_chunk.launches += 1
    return losses


run_grid_chunk.launches = 0


def _grid_launch(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 rows: Sequence[GridRow], *, n_steps: int, batch: int, eps_const: float,
                 tdv: bool, lr: float, dual: bool = False,
                 external_noise: Optional[Sequence[Noise]] = None,
                 adam_dtype: str = "f32", bf16_dots: bool = False,
                 skip: int = 0) -> torch.Tensor:
    """One launch of the kernel over ``rows`` (``run_grid_chunk``'s CUDA
    branch, uncounted). ``skip``, a sum of ``SKIP`` values, leaves parts of
    every step out: timing variants whose results are not used; 0 trains."""
    if skip not in range(sum(SKIP.values()) + 1):
        raise ValueError(f"skip {skip} out of range")
    device, B, n = p.device, batch, len(rows)
    bf16 = moments_bf16(adam_dtype)
    if n == 0:
        raise ValueError("run_grid_chunk needs at least one row")
    if external_noise is not None and len(external_noise) != n:
        raise ValueError(f"external_noise has {len(external_noise)} rows, the launch {n}")
    total = row_offsets(rows, dual)[-1]
    for t, name in ((p, "p"), (m, "m"), (v, "v")):
        _require(t, name, device, (total,))
    losses = torch.empty(n, n_steps, dtype=torch.float32, device=device)
    if n_steps == 0:
        return losses
    table = (Row * n)()
    for i, (r, (rp, rm, rv)) in enumerate(zip(rows, row_views(p, m, v, rows, dual))):
        D, L = r.data_dim, r.latent_dim
        if dual:
            if r.intrinsic_dim != r.manifold_dim or r.var_added > 0:
                raise ValueError(f"row {i}: the sigmoid dataset draws intrinsic_dim = "
                                 f"manifold_dim normals and has no observation noise")
            _require(r.a, f"row {i} a", device, (r.manifold_dim, 1))
        else:
            _require(r.a, f"row {i} a", device, (r.manifold_dim, r.intrinsic_dim))
        need = smem_bytes(B, D, L, r.intrinsic_dim, r.manifold_dim, dual, bf16_dots)
        if need > SMEM_LIMIT:
            raise ValueError(f"row {i} (D {D}, L {L}) needs {need} B of shared memory "
                             f"(limit {SMEM_LIMIT})")
        ext = [None, None, None]
        if external_noise is not None:
            for j, (t, name, dim) in enumerate(zip(external_noise[i], ("x", "z1", "z2"),
                                                   (D, L, D))):
                _require(t, f"row {i} external_noise {name}", device, (n_steps, B, dim))
                ext[j] = t.data_ptr()
        dk, mk = rng.key_words(r.data_seed), rng.key_words(r.model_seed)
        obs = float(np.sqrt(np.float32(r.var_added))) if r.var_added > 0 else 0.0
        table[i] = Row(rp.data_ptr(), rm.data_ptr(), rv.data_ptr(), losses[i].data_ptr(),
                       r.a.data_ptr(), *ext, D, L, r.intrinsic_dim, r.manifold_dim,
                       r.step0 & rng.MASK32, r.t0, dk[0], dk[1], mk[0], mk[1], obs)
    lib = _lib()
    # the same bytes on the card, copied in stream order before the launch
    table_dev = torch.frombuffer(bytearray(table), dtype=torch.uint8).to(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.linear_vae_grid_chunk(ctypes.addressof(table), table_dev.data_ptr(), n,
                                    n_steps, B, int(dual), float(eps_const),
                                    int(bool(tdv)), float(lr), int(bf16),
                                    int(bool(bf16_dots)), int(skip), stream)
    _check(lib, err, "linear_vae_grid_chunk launch")
    return losses


def plain_grid_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     rows: Sequence[GridRow], *, n_steps: int, batch: int, eps_const: float,
                     tdv: bool, lr: float, dual: bool = False,
                     external_noise: Optional[Sequence[Noise]] = None,
                     adam_dtype: str = "f32", bf16_dots: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``run_grid_chunk``: one
    ``plain_fused_chunk`` per row on its slice of the packed buffers, same
    signature, same in-place contract."""
    plain_grid_chunk.calls += 1
    losses = torch.empty(len(rows), n_steps, dtype=torch.float32, device=p.device)
    for i, (r, (rp, rm, rv)) in enumerate(zip(rows, row_views(p, m, v, rows, dual))):
        losses[i] = plain_fused_chunk(
            rp, rm, rv, r.a, n_steps=n_steps, batch=batch, data_dim=r.data_dim,
            latent_dim=r.latent_dim, intrinsic_dim=r.intrinsic_dim,
            manifold_dim=r.manifold_dim, step0=r.step0, t0=r.t0, data_seed=r.data_seed,
            model_seed=r.model_seed, var_added=r.var_added, eps_const=eps_const, tdv=tdv,
            lr=lr, external_noise=None if external_noise is None else external_noise[i],
            dual=dual, adam_dtype=adam_dtype, bf16_dots=bf16_dots)
    return losses


plain_grid_chunk.calls = 0  # chunks run by the plain version (the CPU tests read it)


def make_grid_chunk(models: Sequence, datasets: Sequence, cfg):
    """The grid trainers' ``chunk(states, n_steps, noises=None)`` on K6a:
    one launch per chunk over every row (``grid_supported`` said yes).
    Returns (states, (rows, n_steps) losses)."""
    dual = models[0].dual_sigmoid_decoder
    model = models[0]
    arrays = [d.A.contiguous() for d in datasets]
    lr = float(cfg.learning_rate)

    def chunk(states: Sequence[TrainState], n_steps: int,
              noises: Optional[Sequence[Noise]] = None):
        with span("chunk.pack"):
            rows = [GridRow(d.dimension, mdl.latent_dim, d.intrinsic_dim, d.dim, a, s.step,
                            s.count, s.data_seed, s.model_seed, d.var_added)
                    for mdl, d, a, s in zip(models, datasets, arrays, states)]
            p, m, v = pack_rows(states, rows, dual)
        with span("chunk.launch"):
            losses = run_grid_chunk(p, m, v, rows, n_steps=n_steps, batch=cfg.batch_size,
                                    eps_const=model.epsilon_const, tdv=model.tunable_decoder_var,
                                    lr=lr, dual=dual, external_noise=noises,
                                    adam_dtype=cfg.adam_dtype, bf16_dots=model.bf16_dots)
        with span("chunk.unpack"):
            states = unpack_rows(states, p, m, v, rows, n_steps, dual)
        return states, losses

    return chunk


def _check_draw_shape(rows: int, n_draws: int) -> None:
    if rows < 1 or n_draws < 1 or rows * n_draws > SAMPLER_MAX_CALLS:
        raise ValueError(f"rows and n_draws must be >= 1 with rows * n_draws <= "
                         f"{SAMPLER_MAX_CALLS}, got {rows} and {n_draws}")


def _draw(rows: int, n_draws: int, step: int, stream_id: int, seed: int, device,
          with_words: bool):
    """One launch of T1's draw (csrc/linear_vae.cu philox_draw_kernel)."""
    lib = _lib()
    words = (torch.empty(rows, n_draws, 4, dtype=torch.int32, device=device)
             if with_words else None)
    normals = torch.empty(rows, n_draws, 4, dtype=torch.float32, device=device)
    k0, k1 = rng.key_words(seed)
    err = lib.philox_draw(None if words is None else words.data_ptr(), normals.data_ptr(),
                          rows, n_draws, step & rng.MASK32, stream_id, k0, k1,
                          torch.cuda.current_stream(device).cuda_stream)
    _check(lib, err, "philox_draw launch")
    return words, normals


def sampler_normals(rows: int, n_draws: int, step: int, stream_id: int, seed: int,
                    device) -> torch.Tensor:
    """T1's draw: (rows, n_draws, 4) float32 normals at counters (step,
    row, draw, stream_id) under ``seed``, the training kernels' Philox and
    Box–Muller, with no words buffer. On the CPU it returns the plain
    version, ``rng.box_muller(rng.words(...))``; on the card it launches
    ``philox_draw_kernel`` or raises. ``sampler_normals.launches`` counts
    its launches."""
    _check_draw_shape(rows, n_draws)
    device = torch.device(device)
    if device.type == "cpu":
        return rng.box_muller(rng.words(seed, step, rows, stream_id, n_draws))
    if device.type != "cuda":
        raise ValueError(f"sampler_normals takes a CPU or CUDA device, got {device}")
    normals = _draw(rows, n_draws, step, stream_id, seed, device, False)[1]
    sampler_normals.launches += 1
    return normals


sampler_normals.launches = 0


def sampler_check(rows: int, n_draws: int, step: int, stream_id: int, seed: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draw with its words: (rows, n_draws, 4) int32 words (the uint32
    bits; ``rng.widen`` gives ops/rng.py's int64 values) and the normals, at
    counters (step, row, draw, stream_id): the bitwise check of the
    kernels' Philox against ``ops/rng.py``. On the CPU the plain version;
    on the card the kernel or an error. ``sampler_check.launches`` counts
    its launches."""
    _check_draw_shape(rows, n_draws)
    device = torch.device(device)
    if device.type == "cpu":
        w = rng.words(seed, step, rows, stream_id, n_draws)
        return rng.narrow(w), rng.box_muller(w)
    if device.type != "cuda":
        raise ValueError(f"sampler_check takes a CPU or CUDA device, got {device}")
    words, normals = _draw(rows, n_draws, step, stream_id, seed, device, True)
    sampler_check.launches += 1
    return words, normals


sampler_check.launches = 0


def blocks_per_sm(smem: int, dual: bool = False) -> int:
    """How many blocks of the kernel one SM of the current device holds at
    ``smem`` bytes of shared memory: whether K6a's rows share SMs."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    _check(lib, lib.linear_vae_blocks_per_sm(int(dual), smem, ctypes.byref(blocks)),
           "linear_vae_blocks_per_sm")
    return blocks.value


def kernel_smem_bytes(batch: int, data_dim: int, latent_dim: int, intrinsic_dim: int,
                      manifold_dim: int, dual: bool = False, bf16_dots: bool = False) -> int:
    """The library's own shared-memory figure (to hold ``smem_bytes`` to it)."""
    return int(_lib().linear_vae_smem_bytes(batch, data_dim, latent_dim, intrinsic_dim,
                                            manifold_dim, int(dual), int(bf16_dots)))
