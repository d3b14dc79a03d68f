"""K5, K5-dual and K6b: the fused MLP-VAE training chunk — CUDA wrappers and
plain versions.

Port of ``vae_training_tpu/kernels/mlp_vae.py`` (``run_mlp_fused_chunk`` →
``_make_kernel``, the ``pl.pallas_call`` at ``:644``) in all its branches:
the sphere sweep's 200|200|200 ReLU stacks and MLPs on linear_gaussian (K5);
MLPs on the sigmoid dataset with the dual decoder x̂ = σ(SigDecoder(s)) +
Decoder(s) (K5-dual, ``mlp_vae.py:308-311, 324-329, 349-352``); and grid
mode (K6b, ``grid_n > 0``: many sweep rows, of mixed dims, in one launch).
The kernel itself is ``csrc/mlp_vae.cu``: one cluster launch runs a whole
K-step chunk of every row of a device table (sampling, forward through the
stacks, closed-form ELBO, backward through every layer, Adam). Each row is
trained by one thread-block cluster, its phases separated by cluster
barriers: of ``CLUSTER_WIDE`` CTAs (16, a non-portable size) where that
trains the launch's rows in no more turns than clusters of ``CLUSTER``
(8) would (a solo launch, a few rows), else of ``CLUSTER`` (the sphere
sweep's 15 rows, side by side). A launch has min(rows, the clusters the
card holds at once) clusters, each walking its rows in turn. One warp
computes a unit of a layer product (32 rows × 16 columns, 4 × 4 a lane)
over the whole contraction, as fp32 FMA chains in ascending k (the order
of the fp32 plain version's GEMMs), or in the bf16-dot mode on the tensor
cores in ascending k16 steps, so no result depends on the cluster size,
the cut of the products or the number of rows. Each row's
state stays in the caller's buffers and its activations in a scratch buffer
the wrapper allocates. A solo launch is the same kernel with a one-row table.

``tiles``, ``products``, ``smem_bytes``, ``unit_owners``, ``cluster_size``
and ``cluster_plan`` are the kernel's plan in Python (the C side's
``tiles()``, ``row_smem()`` and ``mlp_vae_grid``): which CTA and warp
computes which unit of each product, the shared memory a CTA stages, and
the cluster size a launch takes, so that the CPU tests can check every
sweep shape and the card can check the library agrees.

A row's state crosses the launch as three flat float32 buffers (params,
Adam m, Adam v) in the layout of ``param_layout``: every Dense layer of the
encoder, then of the decoder (flax names, ``kernel`` (in, out) then
``bias``), then ``epsilon_p`` and ``epsilon``, and with the dual decoder the
``SigDecoder``'s layers after them. With one layer per stack this is K1's
layout (K2's with the dual decoder).

``run_mlp_fused_chunk`` (one row) and ``run_grid_chunk`` (the rows' states
concatenated by ``pack_rows``, one ``GridRow`` each) launch the kernel for
CUDA tensors and raise if they cannot; for CPU tensors (and only for them)
they run ``plain_mlp_fused_chunk`` / ``plain_grid_chunk``, the same chunk on
the torch path behind the same signature. ``.launches`` on each counts its
kernel launches.

``adam_dtype="bf16"`` is K4 here too: the kernel rounds the moments of every
stack's weight matrices to bfloat16 at every step, in float32 buffers
(``kernels/linear_vae.py`` says why that keeps packing exact).

``bf16_dots`` (``--precision bf16`` on the card) is the TPU kernel's
default dot mode (``dotf``, ``dot_t1``, ``dot_t2`` at ``mlp_vae.py:193-205``
with ``prec = None``): every layer product, forward and backward, and the
in-kernel manifold draws take bfloat16 operands, round to nearest even,
with f32 sums; the biases, g_b (the last row of [a_in, 1]ᵀ·G, summed from
the unrounded G), the ReLU masks, the ELBO and Adam stay f32. A launch-wide
flag of K5, K5-dual and K6b, and of the plain versions. The kernel computes
the layer products of this mode with bf16 ``mma.sync`` on the tensor cores
(narrow units of 16 rows, the contraction padded to 16): ``tiles``,
``smem_bytes`` and ``unit_owners`` take the mode.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import rng
from ..train.state import TrainState
from ..train.step import Noise
from ..utils.spans import span
from .linear_vae import (
    GridRow,
    Layout,
    _require,
    cuda_device_ok,
    moments_bf16,
    pack_layout,
    run_plain_chunk,
    unpack_layout_,
)

THREADS = 512  # a CTA's threads (kThreads in csrc/mlp_vae.cu)
WARPS = THREADS // 32
CLUSTER = 8  # CTAs a row: the portable cluster size (kCluster)
CLUSTER_WIDE = 16  # the wide one, for launches of few rows (kClusterWide)
TILE_M, TILE_N = 32, 16  # a unit: TILE_M × TILE_N outputs, one warp's (kTileM, kTileN)
TILE_M_NARROW = 8  # a narrow product's units (M or N ≤ TILE_N): 8 rows (kTileMNarrow)
KSTEP = 4  # contractions run four k at a time (kKStep)
TILE_M_NARROW_BF16 = 16  # bf16 dots: a narrow unit is one mma tile high (kTileMNarrowBf16)
KSTEP_BF16 = 16  # bf16 dots: contractions run in mma.sync's k16 steps (kKStepBf16)
SMEM_MAX = 232448  # shared memory a CTA can have on sm_90 (kSmemMax)
HEADER = 1024  # the row and the loss partials, before the stage (kHeader)
MAX_LAYERS = 8  # Dense layers per stack (kMaxLayers)
MAX_ROWS = 256  # rows a launch (kMaxRows)
SKIP = {"mma": 1, "stage": 2, "adam": 4, "work": 8}  # timing variants (kSkip*)
KINDS = {"sphere": 0, "linear": 1, "sigmoid": 2}  # the manifolds sampled in-kernel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Product:
    """One product of a cluster phase: out (M × N) = A (M × K) · B (K × N),
    ``pairs`` of one shape side by side (the dual decoder's). ``a_t``: A is
    read as [k][m] (its layout in device memory), ``b_t``: B as [n][k].
    The epilogue reads ``vecs`` vectors and ``mats`` matrices, staged with
    the operands. With the dual decoder the Decoder's and the SigDecoder's
    products (but the residual and g_s, which take both) run side by side,
    each on half the cluster (``half``)."""
    phase: str
    M: int
    N: int
    K: int
    a_t: bool
    b_t: bool
    pairs: int = 1
    vecs: int = 0  # the epilogue's input vectors (N) and matrices (M × N)
    mats: int = 0
    half: bool = False  # on half the cluster (the dual decoder's stacks side by side)

    def ctas(self, cluster: int) -> int:
        """The CTAs that share this product on a cluster of ``cluster``."""
        return cluster // 2 if self.half else cluster


def _odd4(x: int) -> int:
    """The least 4·odd stride of at least x + 4 floats (``odd4()``)."""
    return x + 4 if (x // 4) % 2 == 0 else x + 8


def tiles(M: int, N: int, K: int, a_t: bool, b_t: bool, pairs: int = 1,
          cluster: int = CLUSTER, vecs: int = 0, mats: int = 0, bf16_dots: bool = False) -> dict:
    """The kernel's tile plan of one product (``tiles()`` in csrc/mlp_vae.cu,
    the same integer arithmetic) in the fp32 or the bf16-dot mode: units of
    ``tm`` × TILE_N outputs (``tm`` = TILE_M, or where M or N is at most
    TILE_N TILE_M_NARROW, with bf16 dots TILE_M_NARROW_BF16), the cluster's
    CTAs as qm × qn over the m-tiles and n-tiles (qn the largest power of
    two up to the n-tiles, so that a narrow product spreads its rows),
    ``mpc`` m-tiles and ``spc`` n-tiles a CTA, the contraction padded to the
    k step (KSTEP; bf16 dots: KSTEP_BF16) and staged in chunks of ``kc``
    (the largest multiple of the k step whose stage fits beside the
    epilogue's inputs), the strides ``sa`` and ``sb`` of A's and B's staged
    rows, and the stage's bytes (-1: none fits)."""
    narrow = M <= TILE_N or N <= TILE_N
    tm = (TILE_M_NARROW_BF16 if bf16_dots else TILE_M_NARROW) if narrow else TILE_M
    m_tiles, n_tiles = _cdiv(M, tm), _cdiv(N, TILE_N)
    qn = 1  # the cluster as qm × qn CTAs: qn the largest power of two ≤ the n-tiles
    while 2 * qn <= cluster and 2 * qn <= n_tiles:
        qn *= 2
    mpc, spc = _cdiv(m_tiles, cluster // qn), _cdiv(n_tiles, qn)
    ks = KSTEP_BF16 if bf16_dots else KSTEP
    k_pad = _cdiv(K, ks) * ks
    mp, ncp = tm * mpc, TILE_N * spc
    e_floats = vecs * ncp + mats * mp * (ncp + 4)
    pad = 4 if bf16_dots else 8  # the [k][m] and [k][n] rows' padding
    alpha = (mp + pad if a_t else mp) + (ncp if b_t else ncp + pad)
    beta = (0 if a_t else 8 * mp) + (8 * ncp if b_t else 0)
    per = ((SMEM_MAX - HEADER) // 4 - e_floats) // pairs
    kc = min((per - beta) // alpha // ks * ks if per > beta else 0, k_pad)
    sk = kc + 8 if bf16_dots else _odd4(kc)  # the [m][k] and [n][k] rows' stride
    sa = mp + pad if a_t else sk
    sb = sk if b_t else ncp + pad
    a_floats = kc * sa if a_t else mp * sa
    b_floats = ncp * sb if b_t else kc * sb
    return dict(tm=tm, m_tiles=m_tiles, n_tiles=n_tiles, qn=qn, mpc=mpc, spc=spc, k_pad=k_pad,
                kc=kc, sa=sa, sb=sb,
                bytes=4 * (pairs * (a_floats + b_floats) + e_floats) if kc > 0 else -1)


def products(batch: int, enc_widths: Sequence[int], dec_widths: Sequence[int],
             dual: bool = False) -> List[Product]:
    """Every product of one training step of a row, in the kernel's order:
    the encoder's and the decoder's forward (the decoder's last layer one
    pair with the dual decoder; its hidden layers run the SigDecoder's
    product after the decoder's, of the same shape), then the decoder's and
    the encoder's backward: each layer's [a_in, 1]ᵀ·G (g_W, and g_b as its
    last row) and, below the first layer, g_in = G·Wᵀ; at the decoder's
    first layer g_s (a pair with the dual decoder)."""
    B, enc, dec = batch, tuple(enc_widths), tuple(dec_widths)
    np_ = 2 if dual else 1
    n_enc, n_dec = len(enc) - 1, len(dec) - 1
    # the epilogues' inputs: a hidden layer's bias; mu's bias, epsilon_p and
    # z1; the residual's biases, z2 and x; g_in's ReLU input; g_s's mu
    out = [Product(f"enc fwd {li}", B, enc[li + 1], enc[li], False, False, 1,
                   2 if li + 1 == n_enc else 1, 1 if li + 1 == n_enc else 0)
           for li in range(n_enc)]
    out += [Product(f"dec fwd {li}", B, dec[li + 1], dec[li], False, False, np_, np_, 2)
            if li + 1 == n_dec else
            Product(f"dec fwd {li}", B, dec[li + 1], dec[li], False, False, 1, 1, 0, dual)
            for li in range(n_dec)]
    for li in reversed(range(n_dec)):
        out.append(Product(f"dec g_W {li}", dec[li] + 1, dec[li + 1], B, True, False,
                           half=dual))
        out.append(Product(f"dec g_in {li}", B, dec[li], dec[li + 1], False, True, 1, 0, 1, dual)
                   if li else
                   Product("dec g_s", B, dec[li], dec[li + 1], False, True, np_, 0, 1))
    for li in reversed(range(n_enc)):
        out.append(Product(f"enc g_W {li}", enc[li] + 1, enc[li + 1], B, True, False))
        if li:
            out.append(Product(f"enc g_in {li}", B, enc[li], enc[li + 1], False, True, 1, 0, 1))
    return out


def smem_bytes(batch: int, enc_widths: Sequence[int], dec_widths: Sequence[int],
               dual: bool = False, cluster: int = CLUSTER, bf16_dots: bool = False) -> int:
    """Shared memory a CTA of a cluster of ``cluster`` needs for one row in
    the dot mode ``bf16_dots`` (``row_smem()`` in csrc/mlp_vae.cu): the
    header and the largest stage; -1 if a product's stage fits no chunk."""
    sizes = [tiles(p.M, p.N, p.K, p.a_t, p.b_t, p.pairs, p.ctas(cluster), p.vecs,
                   p.mats, bf16_dots)["bytes"]
             for p in products(batch, enc_widths, dec_widths, dual)]
    return -1 if min(sizes) < 0 else HEADER + max(sizes)


def unit_owners(prod: Product, cluster: int = CLUSTER,
                bf16_dots: bool = False) -> List[Tuple[int, int, int, int, int]]:
    """Who computes what of one product, as the kernel assigns it on a
    cluster of ``cluster`` CTAs (of its half, for a ``half`` product) in the
    dot mode ``bf16_dots``: (cta, round, warp, m0, n0), each the owner
    of the tm × TILE_N unit at (m0, n0) (``tiles``' tm). CTA q = (q // qn, q % qn)
    takes m-tiles [(q // qn)·mpc, …) and n-tiles [(q % qn)·spc, …); its
    units s = nl·mt_n + ml go to warp s mod WARPS in round s // WARPS."""
    cluster = prod.ctas(cluster)
    t = tiles(prod.M, prod.N, prod.K, prod.a_t, prod.b_t, prod.pairs, cluster, prod.vecs,
              prod.mats, bf16_dots)
    out = []
    for q in range(cluster):
        mt_lo, nt_lo = (q // t["qn"]) * t["mpc"], (q % t["qn"]) * t["spc"]
        mt_n = min(t["mpc"], t["m_tiles"] - mt_lo)
        nt_n = min(t["spc"], t["n_tiles"] - nt_lo)
        if mt_n <= 0 or nt_n <= 0:
            continue
        for s in range(mt_n * nt_n):
            out.append((q, s // WARPS, s % WARPS, t["tm"] * (mt_lo + s % mt_n),
                        TILE_N * (nt_lo + s // mt_n)))
    return out


def cluster_size(n_rows: int, max_clusters: dict) -> int:
    """The cluster size a launch of ``n_rows`` rows takes (``mlp_vae_grid``):
    of {size: the clusters of that size the card holds at once}, the size
    that trains the rows in the fewest turns, ``CLUSTER_WIDE`` on a tie."""
    def turns(size):
        most = max_clusters.get(size, 0)
        return _cdiv(n_rows, most) if most >= 1 else float("inf")

    return CLUSTER_WIDE if turns(CLUSTER_WIDE) <= turns(CLUSTER) else CLUSTER


def cluster_plan(n_rows: int, max_clusters: int) -> List[Tuple[int, int]]:
    """Row i of a launch → (its cluster, its turn on that cluster): the
    launch has min(n_rows, max_clusters) clusters, and cluster k trains rows
    k, k + n_clusters, … in turn."""
    n = min(n_rows, max_clusters)
    return [(i % n, i // n) for i in range(n_rows)]


def stack_widths(model) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(encoder widths, decoder widths) of a model, inputs included:
    (D, h₁, …, L) and (L, h₁, …, D). The SigDecoder mirrors the decoder."""
    return ((model.data_dim,) + model.encoder_features,
            (model.latent_dim,) + model.decoder_features)


def param_layout(enc_widths: Sequence[int], dec_widths: Sequence[int],
                 dual: bool = False) -> Layout:
    """Flat order of the state buffers (csrc/mlp_vae.cu agrees): K5's
    layout, then with the dual decoder the SigDecoder's layers."""

    def dense(group, w):
        return [entry for i in range(len(w) - 1) for entry in (
            (f"{group}.FC{i}.kernel", (w[i], w[i + 1])), (f"{group}.FC{i}.bias", (w[i + 1],)))]

    layout = (dense("Encoder", enc_widths) + dense("Decoder", dec_widths)
              + [("epsilon_p", (enc_widths[-1],)), ("epsilon", (1,))])
    return layout + dense("SigDecoder", dec_widths) if dual else layout


def n_params(enc_widths: Sequence[int], dec_widths: Sequence[int], dual: bool = False) -> int:
    return sum(int(np.prod(s)) for _, s in param_layout(enc_widths, dec_widths, dual))


def pack_state(state: TrainState, enc_widths, dec_widths, dual: bool = False):
    layout = param_layout(enc_widths, dec_widths, dual)
    return tuple(pack_layout(d, layout) for d in (state.params, state.m, state.v))


def unpack_state(state: TrainState, p, m, v, n_steps: int, enc_widths,
                 dec_widths, dual: bool = False) -> TrainState:
    layout = param_layout(enc_widths, dec_widths, dual)
    for flat, d in ((p, state.params), (m, state.m), (v, state.v)):
        unpack_layout_(flat, d, layout)
    state.step += n_steps
    state.count += n_steps
    return state


def dataset_kind(dataset) -> Optional[str]:
    from ..data.synthetic import LinearGaussianDataset, SigmoidDataset, SphereDataset

    if isinstance(dataset, SphereDataset):
        return "sphere"
    if isinstance(dataset, LinearGaussianDataset):
        return "linear"
    if isinstance(dataset, SigmoidDataset):
        return "sigmoid"
    return None


def _structure(model, dataset) -> Tuple[bool, str]:
    """The model and dataset part of ``supported``. Returns (ok, reason)."""
    kind = dataset_kind(dataset)
    if kind is None:
        return False, "the MLP kernel supports the sphere, linear_gaussian and sigmoid datasets"
    if kind == "sigmoid" and not model.dual_sigmoid_decoder:
        return False, "the sigmoid dataset expects the dual decoder"
    if kind != "sigmoid" and model.dual_sigmoid_decoder:
        return False, "the dual decoder expects the sigmoid dataset"
    enc, dec = stack_widths(model)
    if len(enc) < 3 and len(dec) < 3:
        return False, "pure-linear configs use the linear kernel"
    if max(len(enc), len(dec)) - 1 > MAX_LAYERS:
        return False, f"the MLP kernel takes at most {MAX_LAYERS} layers a stack"
    name = {"sphere": "sphere", "linear": "linear_gaussian",
            "sigmoid": "sigmoid with the dual decoder"}[kind]
    return True, (f"ReLU MLP VAE on {name}, "
                  f"{n_params(enc, dec, model.dual_sigmoid_decoder)} parameters")


def _fits(model, batch: int) -> Tuple[bool, str]:
    enc, dec = stack_widths(model)
    if smem_bytes(batch, enc, dec, model.dual_sigmoid_decoder,
                  bf16_dots=getattr(model, "bf16_dots", False)) < 0:
        return False, (f"batch {batch} with widths {enc} / {dec}: a product's stage does "
                       f"not fit {SMEM_MAX} B of shared memory in chunks of 16")
    return True, ""


def supported(model, dataset, cfg) -> Tuple[bool, str]:
    """Whether K5 can run this configuration (the counterpart of
    ``mlp_pallas_supported``, ``mlp_vae.py:682-724``, re-derived for the
    card): ReLU stacks with a hidden layer in at least one of them (pure
    linear nets take the linear kernel); the sphere or linear_gaussian
    dataset without the dual decoder, or the sigmoid dataset with it (K5's
    dual branch); at most ``MAX_LAYERS`` layers a stack; and a CUDA device
    of compute capability 9.0. The TPU kernel's batch ≤ 128 and widths ≤ 512
    were VMEM and lane limits and do not apply: the state lives in device
    memory."""
    ok, why = _structure(model, dataset)
    if not ok:
        return False, why
    ok, why_smem = _fits(model, cfg.batch_size)
    if not ok:
        return False, why_smem
    ok, why_dev = cuda_device_ok(cfg)
    if not ok:
        return False, why_dev
    return True, why


def grid_supported(models: Sequence, datasets: Sequence, cfg) -> Tuple[bool, str]:
    """Whether K6b can run these rows in one launch (the MLP branch of the
    JAX package's ``mixed_launch_eligible``, ``mixed_grid.py:42-113``).
    ``models``, ``datasets`` and ``cfg`` give one row each (``cfg`` may be
    one config for all rows). Every row must pass ``supported``'s model
    checks; the rows may differ only in their dims and seeds: the layer
    counts and hidden widths, batch, learning rate, ε, -tdv, the decoder
    head, the dataset kind and its observation noise, and the step count
    and the print and plot cadences (so every row shares every chunk
    boundary) are uniform, and so are the Adam moment dtype
    (``--adam_dtype``) and ``--precision`` (the dot mode, with the model's
    resolved ``bf16_dots``), the launch's flags. The device is a CUDA device of compute capability
    9.0, or the CPU, where ``run_grid_chunk`` runs the plain version. A
    refusal names the first row that fails."""
    cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else [cfg] * len(models)
    if not models or not len(models) == len(datasets) == len(cfgs):
        return False, (f"need one model, dataset and config a row, got {len(models)}, "
                       f"{len(datasets)} and {len(cfgs)}")
    if len(models) > MAX_ROWS:
        return False, f"{len(models)} rows; one launch takes at most {MAX_ROWS}"

    def uniform(model, dataset, c):
        return {"layer counts": (len(model.encoder_features), len(model.decoder_features)),
                "hidden widths": (model.encoder_features[:-1], model.decoder_features[:-1]),
                "batch size": c.batch_size, "learning rate": float(c.learning_rate),
                "adam_dtype": c.adam_dtype,
                "precision": (getattr(c, "precision", "bf16"), getattr(model, "bf16_dots", False)),
                "epsilon": model.epsilon_const, "-tdv": model.tunable_decoder_var,
                "decoder head": model.dual_sigmoid_decoder,
                "dataset": type(dataset).__name__,
                "observation noise": float(dataset.var_added),
                "num_batches": c.num_batches, "n_print": c.n_print, "n_plot": c.n_plot,
                "device": str(c.device)}

    ref = uniform(models[0], datasets[0], cfgs[0])
    sizes = []
    for i, (model, dataset, c) in enumerate(zip(models, datasets, cfgs)):
        for key, val in uniform(model, dataset, c).items():
            if val != ref[key]:
                return False, (f"row {i} differs from row 0 in {key} ({val!r} vs "
                               f"{ref[key]!r}); one launch takes rows that differ "
                               f"only in dims and seeds")
        ok, why = _structure(model, dataset)
        if ok:
            ok, why = _fits(model, c.batch_size)
        if not ok:
            return False, f"row {i}: {why}"
        sizes.append(n_params(*stack_widths(model), model.dual_sigmoid_decoder))
    if torch.device(cfgs[0].device).type != "cpu":
        ok, why = cuda_device_ok(cfgs[0])
        if not ok:
            return False, why
    enc_h, dec_h = ref["hidden widths"]
    head = " with the dual decoder" if models[0].dual_sigmoid_decoder else ""
    return True, (f"{len(models)} ReLU MLP VAE rows on {dataset_kind(datasets[0])}{head}, "
                  f"hidden widths {'|'.join(map(str, enc_h))} / {'|'.join(map(str, dec_h))}, "
                  f"up to {max(sizes)} parameters a row")


class Stack(ctypes.Structure):
    """``struct Stack`` in csrc/mlp_vae.cu."""
    _fields_ = [("n", ctypes.c_int), ("widths", ctypes.c_int * (MAX_LAYERS + 1))] + [
        (name, ctypes.c_int * MAX_LAYERS) for name in ("w_off", "b_off", "act")]


class Row(ctypes.Structure):
    """One row of the kernel's device table: ``struct Row`` in
    csrc/mlp_vae.cu, field by field (``_lib`` holds the two to one size).
    The wrapper fills the fields up to ``obs_scale``; the library plans the
    rest."""
    _fields_ = [(name, ctypes.c_void_p) for name in ("p", "m", "v", "losses", "scratch")] + [
        ("scratch_floats", ctypes.c_longlong)] + [
        (name, ctypes.c_void_p) for name in ("a", "ext_x", "ext_z1", "ext_z2")] + [
        (name, ctypes.c_int) for name in ("D", "L", "id", "dd")] + [
        ("step0", ctypes.c_uint), ("t0", ctypes.c_int), ("dk0", ctypes.c_uint),
        ("dk1", ctypes.c_uint), ("mk0", ctypes.c_uint), ("mk1", ctypes.c_uint),
        ("obs_scale", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in ("P", "o_ep", "o_eps")] + [
        (name, Stack) for name in ("enc", "dec", "sig")] + [
        (name, ctypes.c_int) for name in ("s_g", "s_nz", "s_x", "s_z1", "s_z2", "s_mu", "s_s",
                                          "s_r", "s_gy", "s_gu", "s_gs", "s_gmu")] + [
        ("s_buf", ctypes.c_int * 2), ("s_sbuf", ctypes.c_int * 2)]


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ._build import load_library

        lib = load_library("mlp_vae")[0]
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ip, rp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(Row)
        lib.mlp_vae_chunk.argtypes = [rp, vp] + [i32] * 6 + [ip, i32, ip, f32, i32, f32, i32,
                                                               i32, i32, i32, vp]
        # ... moments bf16, dots bf16, cluster, skip, stream
        lib.mlp_vae_chunk.restype = i32
        lib.mlp_vae_plan_row.argtypes = [rp] + [i32] * 4 + [ip, i32, ip]
        lib.mlp_vae_plan_row.restype = ctypes.c_longlong
        lib.mlp_vae_smem_bytes.argtypes = [i32] * 5 + [ip, i32, ip, i32, i32]
        lib.mlp_vae_smem_bytes.restype = i32
        lib.mlp_vae_row_bytes.argtypes = []
        lib.mlp_vae_row_bytes.restype = ctypes.c_size_t
        lib.mlp_vae_grid.argtypes = [i32, ip, i32, i32, ip, ip, ip]
        lib.mlp_vae_cluster_sizes.argtypes = [ip]
        lib.mlp_vae_cluster_sizes.restype = None
        lib.mlp_vae_grid.restype = i32
        lib.mlp_vae_last_launch.argtypes = [ip, ip, ip]
        lib.mlp_vae_last_launch.restype = None
        lib.mlp_vae_error_string.argtypes = [i32]
        lib.mlp_vae_error_string.restype = ctypes.c_char_p
        if lib.mlp_vae_row_bytes() != ctypes.sizeof(Row):
            raise RuntimeError(f"csrc/mlp_vae.cu's Row is {lib.mlp_vae_row_bytes()} B, "
                               f"kernels/mlp_vae.py's {ctypes.sizeof(Row)} B")
        sizes = _int_array([0, 0])
        lib.mlp_vae_cluster_sizes(sizes)
        if (tuple(sizes), lib.mlp_vae_threads()) != ((CLUSTER, CLUSTER_WIDE), THREADS):
            raise RuntimeError(f"csrc/mlp_vae.cu's clusters and CTA are "
                               f"{tuple(sizes)} x {lib.mlp_vae_threads()}, "
                               f"kernels/mlp_vae.py's {(CLUSTER, CLUSTER_WIDE)} x {THREADS}")
        _LIB = lib
    return _LIB


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.mlp_vae_error_string(err).decode()})")


def _int_array(values: Sequence[int]):
    return (ctypes.c_int * max(len(values), 1))(*values)


def grid(n_rows: int, smem: dict, cluster: int = 0, bf16_dots: bool = False) -> dict:
    """The cluster plan of a launch of ``n_rows`` rows in the dot mode
    ``bf16_dots`` whose CTAs need ``smem[size]`` bytes of shared memory on
    clusters of each size, on the current device: {"clusters",
    "cluster_size", "max_clusters"}; the launch has ``clusters`` =
    min(n_rows, max_clusters) clusters of ``cluster_size`` (``cluster_size``
    picks it; ``cluster`` names one instead), and ``cluster_plan`` maps rows
    to them."""
    lib = _lib()
    vals = [ctypes.c_int(0) for _ in range(3)]
    _check(lib, lib.mlp_vae_grid(n_rows, _int_array([smem[CLUSTER], smem[CLUSTER_WIDE]]),
                                 cluster, int(bool(bf16_dots)), *map(ctypes.byref, vals)),
           "mlp_vae_grid")
    return dict(zip(("clusters", "cluster_size", "max_clusters"), (x.value for x in vals)))


def last_launch() -> dict:
    """What the library's last launch used: {"clusters", "cluster_size",
    "smem"} (a cluster launch; there is no other kind)."""
    lib = _lib()
    vals = [ctypes.c_int(0) for _ in range(3)]
    lib.mlp_vae_last_launch(*map(ctypes.byref, vals))
    return dict(zip(("clusters", "cluster_size", "smem"), (x.value for x in vals)))


def library_smem_bytes(batch: int, enc_widths: Sequence[int], dec_widths: Sequence[int],
                       dual: bool = False, cluster: int = CLUSTER,
                       bf16_dots: bool = False) -> int:
    """``smem_bytes`` as the library computes it (for the card's check that
    the two plans agree)."""
    enc, dec = tuple(enc_widths), tuple(dec_widths)
    return _lib().mlp_vae_smem_bytes(batch, enc[0], enc[-1], int(dual), len(enc) - 1,
                                     _int_array(enc[1:-1]), len(dec) - 1,
                                     _int_array(dec[1:-1]), cluster, int(bool(bf16_dots)))


def row_widths(row: GridRow, enc_hidden: Sequence[int], dec_hidden: Sequence[int]):
    """A row's (encoder widths, decoder widths) from its dims and the
    launch's hidden widths."""
    D, L = row.data_dim, row.latent_dim
    return (D, *enc_hidden, L), (L, *dec_hidden, D)


def _launch(bufs, losses: torch.Tensor, rows: Sequence[GridRow], *, n_steps: int, batch: int,
            enc_hidden: Sequence[int], dec_hidden: Sequence[int], kind: str, eps_const: float,
            tdv: bool, lr: float, dual: bool, external_noise, adam_dtype: str,
            bf16_dots: bool = False, cluster: int = 0, skip: int = 0) -> None:
    """One launch over ``rows``, row i training ``bufs[i]`` = its (p, m, v)
    in place and writing ``losses[i]``: what K5 (one row) and K6b share.
    ``cluster`` names the cluster size (0: the launch's choice; no result
    depends on it). ``skip`` (a sum of ``SKIP`` values) leaves parts of the
    kernel out, for timing only: the training entry points
    ``run_mlp_fused_chunk`` and ``run_grid_chunk`` take no such argument."""
    if cluster not in (0, CLUSTER, CLUSTER_WIDE) or skip not in range(sum(SKIP.values()) + 1):
        raise ValueError(f"cluster {cluster} or skip {skip} out of range")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    n_enc, n_dec = len(enc_hidden) + 1, len(dec_hidden) + 1
    if max(n_enc, n_dec) > MAX_LAYERS or min(list(enc_hidden) + list(dec_hidden) + [1]) < 1:
        raise ValueError(f"each stack takes 1..{MAX_LAYERS} layers of positive width: "
                         f"{tuple(enc_hidden)}, {tuple(dec_hidden)}")
    if external_noise is not None and len(external_noise) != len(rows):
        raise ValueError(f"external_noise has {len(external_noise)} rows, the launch {len(rows)}")
    if len(rows) > MAX_ROWS:
        raise ValueError(f"{len(rows)} rows; one launch takes at most {MAX_ROWS}")
    device, B = losses.device, batch
    bf16 = moments_bf16(adam_dtype)
    lib = _lib()
    enc_arr, dec_arr = _int_array(enc_hidden), _int_array(dec_hidden)
    shape = (B, KINDS[kind], int(dual), n_enc, enc_arr, n_dec, dec_arr)
    table = (Row * len(rows))()
    needs = []
    for i, (r, (p, m, v)) in enumerate(zip(rows, bufs)):
        D, L = r.data_dim, r.latent_dim
        P = n_params(*row_widths(r, enc_hidden, dec_hidden), dual)
        for t, name in ((p, "p"), (m, "m"), (v, "v")):
            _require(t, f"row {i} {name}", device, (P,))
        a_ptr = None
        if kind == "linear":
            _require(r.a, f"row {i} a", device, (r.manifold_dim, r.intrinsic_dim))
            a_ptr = r.a.data_ptr()
        elif r.intrinsic_dim != r.manifold_dim or r.var_added > 0:
            raise ValueError(f"row {i}: the {kind} dataset draws intrinsic_dim = manifold_dim "
                             f"normals and has no observation noise")
        elif kind == "sigmoid":
            _require(r.a, f"row {i} a", device, (r.manifold_dim, 1))
            a_ptr = r.a.data_ptr()
        ext = [None, None, None]
        if external_noise is not None:
            for j, (t, name, dim) in enumerate(zip(external_noise[i], ("x", "z1", "z2"),
                                                   (D, L, D))):
                _require(t, f"row {i} external_noise {name}", device, (n_steps, B, dim))
                ext[j] = t.data_ptr()
        dk, mk = rng.key_words(r.data_seed), rng.key_words(r.model_seed)
        obs = float(np.sqrt(np.float32(r.var_added))) if r.var_added > 0 else 0.0
        table[i] = Row(p=p.data_ptr(), m=m.data_ptr(), v=v.data_ptr(),
                       losses=losses[i].data_ptr(), a=a_ptr, ext_x=ext[0], ext_z1=ext[1],
                       ext_z2=ext[2], D=D, L=L, id=r.intrinsic_dim, dd=r.manifold_dim,
                       step0=r.step0 & rng.MASK32, t0=r.t0, dk0=dk[0], dk1=dk[1], mk0=mk[0],
                       mk1=mk[1], obs_scale=obs)
        need = lib.mlp_vae_plan_row(ctypes.byref(table[i]), *shape)
        if need < 0 or table[i].P != P:
            raise ValueError(f"row {i}: the kernel refuses these shapes: batch {B}, D {D}, "
                             f"L {L}, intrinsic {r.intrinsic_dim}, manifold {r.manifold_dim}, "
                             f"{kind}, hidden {tuple(enc_hidden)} / {tuple(dec_hidden)}")
        needs.append(need)
    # one scratch buffer, each row's slice its own
    scratch = torch.empty(sum(needs), dtype=torch.float32, device=device)
    off = 0
    for row, need in zip(table, needs):
        row.scratch, row.scratch_floats = scratch.data_ptr() + 4 * off, need
        off += need
    rows_dev = torch.empty(len(rows) * ctypes.sizeof(Row), dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.mlp_vae_chunk(table, rows_dev.data_ptr(), len(rows), n_steps, *shape,
                            float(eps_const), int(bool(tdv)), float(lr), int(bf16),
                            int(bool(bf16_dots)), int(cluster), int(skip), stream)
    _check(lib, err, "mlp_vae_chunk launch")


def run_mlp_fused_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                        a: Optional[torch.Tensor], *, n_steps: int, batch: int,
                        enc_widths: Sequence[int], dec_widths: Sequence[int],
                        kind: str, intrinsic_dim: int, manifold_dim: int,
                        step0: int, t0: int, data_seed: int, model_seed: int,
                        var_added: float, eps_const: float, tdv: bool, lr: float,
                        external_noise: Optional[Noise] = None,
                        dual: bool = False, adam_dtype: str = "f32",
                        bf16_dots: bool = False) -> torch.Tensor:
    """Train ``n_steps`` steps from the flat state (p, m, v), in place.
    Returns the (n_steps,) losses. ``kind`` is "sphere" (``a`` unused,
    intrinsic_dim = manifold_dim), "linear" (``a`` is A, manifold_dim ×
    intrinsic_dim) or "sigmoid" (``a`` is the column a, manifold_dim × 1,
    intrinsic_dim = manifold_dim; with ``dual``, the dual decoder).
    ``enc_widths`` = (D, h₁, …, L) and ``dec_widths`` = (L, h₁, …, D).
    ``step0`` is the absolute step of the first step (the Philox counter)
    and ``t0`` the Adam count before it. ``external_noise`` = (x, z1, z2),
    each (n_steps, batch, dim), replaces the in-kernel sampler (the test
    hook of the TPU kernel). ``adam_dtype="bf16"`` rounds the weight
    matrices' moments to bfloat16 every step (K4); ``bf16_dots`` makes every
    dot take bfloat16 operands and f32 sums."""
    kw = dict(n_steps=n_steps, batch=batch, enc_widths=enc_widths,
              dec_widths=dec_widths, kind=kind, intrinsic_dim=intrinsic_dim,
              manifold_dim=manifold_dim, step0=step0, t0=t0, data_seed=data_seed,
              model_seed=model_seed, var_added=var_added, eps_const=eps_const,
              tdv=tdv, lr=lr, external_noise=external_noise, dual=dual,
              adam_dtype=adam_dtype, bf16_dots=bf16_dots)
    if p.device.type == "cpu":
        return plain_mlp_fused_chunk(p, m, v, a, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"run_mlp_fused_chunk takes CPU or CUDA tensors, got {p.device}")
    enc, dec = tuple(enc_widths), tuple(dec_widths)
    if len(enc) < 2 or len(dec) < 2 or dec[0] != enc[-1] or dec[-1] != enc[0]:
        raise ValueError(f"stacks do not chain: encoder {enc}, decoder {dec}")
    losses = torch.empty(1, n_steps, dtype=torch.float32, device=p.device)
    if n_steps == 0:
        return losses[0]
    row = GridRow(enc[0], enc[-1], intrinsic_dim, manifold_dim, a, step0, t0, data_seed,
                  model_seed, var_added)
    _launch([(p, m, v)], losses, [row], n_steps=n_steps, batch=batch, enc_hidden=enc[1:-1],
            dec_hidden=dec[1:-1], kind=kind, eps_const=eps_const, tdv=tdv, lr=lr, dual=dual,
            external_noise=None if external_noise is None else [external_noise],
            adam_dtype=adam_dtype, bf16_dots=bf16_dots)
    run_mlp_fused_chunk.launches += 1
    return losses[0]


run_mlp_fused_chunk.launches = 0


def plain_mlp_fused_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                          a: Optional[torch.Tensor], *, n_steps: int, batch: int,
                          enc_widths: Sequence[int], dec_widths: Sequence[int],
                          kind: str, intrinsic_dim: int, manifold_dim: int,
                          step0: int, t0: int, data_seed: int, model_seed: int,
                          var_added: float, eps_const: float, tdv: bool, lr: float,
                          external_noise: Optional[Noise] = None,
                          dual: bool = False, adam_dtype: str = "f32",
                          bf16_dots: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``run_mlp_fused_chunk``: the same chunk
    on the torch path (autograd + the explicit Adam update), same signature,
    same in-place contract; the model and the dataset take ``bf16_dots``."""
    from ..data.synthetic import LinearGaussianDataset, SigmoidDataset, SphereDataset
    from ..models.networks import build_vae

    enc, dec = tuple(enc_widths), tuple(dec_widths)
    D, L = enc[0], enc[-1]
    model = build_vae(data_dim=D, latent_dim=L,
                      encoder_layer_sizes="|".join(map(str, enc[1:-1])),
                      decoder_layer_sizes="|".join(map(str, dec[1:-1])),
                      epsilon=eps_const, tunable_decoder_var=tdv,
                      dataset_name="sigmoid" if dual else None, bf16_dots=bf16_dots)
    if kind == "sphere":
        dataset = SphereDataset(manifold_dim, D - manifold_dim, device=p.device)
    elif kind == "sigmoid":
        dataset = SigmoidDataset(a, manifold_dim, D - manifold_dim - 1, bf16_dots)
    else:
        dataset = LinearGaussianDataset(a, manifold_dim, intrinsic_dim,
                                        D - manifold_dim, var_added, bf16_dots)
    return run_plain_chunk(p, m, v, param_layout(enc, dec, dual), model, dataset,
                           n_steps=n_steps, batch=batch, step0=step0, t0=t0,
                           data_seed=data_seed, model_seed=model_seed, tdv=tdv,
                           lr=lr, external_noise=external_noise, adam_dtype=adam_dtype)


def make_train_chunk(model, dataset, cfg):
    """The Trainer's ``train_chunk(state, n_steps)`` on K5 (its dual branch
    on the sigmoid dataset)."""
    enc, dec = stack_widths(model)
    kind = dataset_kind(dataset)
    dual = model.dual_sigmoid_decoder
    a = dataset.A.contiguous() if kind != "sphere" else None
    lr = float(cfg.learning_rate)

    def train_chunk(state: TrainState, n_steps: int, noise: Optional[Noise] = None):
        p, m, v = pack_state(state, enc, dec, dual)
        losses = run_mlp_fused_chunk(
            p, m, v, a, n_steps=n_steps, batch=cfg.batch_size, enc_widths=enc,
            dec_widths=dec, kind=kind, intrinsic_dim=dataset.intrinsic_dim,
            manifold_dim=dataset.dim, step0=state.step, t0=state.count,
            data_seed=state.data_seed, model_seed=state.model_seed,
            var_added=dataset.var_added, eps_const=model.epsilon_const,
            tdv=model.tunable_decoder_var, lr=lr, external_noise=noise, dual=dual,
            adam_dtype=cfg.adam_dtype, bf16_dots=model.bf16_dots)
        return unpack_state(state, p, m, v, n_steps, enc, dec, dual), losses

    return train_chunk


# --- K6b: many rows in one launch ----------------------------------------------


def row_offsets(rows: Sequence[GridRow], enc_hidden: Sequence[int], dec_hidden: Sequence[int],
                dual: bool = False) -> List[int]:
    """Start of each row's slice in the packed buffers, and their total
    length last: rows lie back to back in the order given."""
    offs = [0]
    for r in rows:
        offs.append(offs[-1] + n_params(*row_widths(r, enc_hidden, dec_hidden), dual))
    return offs


def pack_rows(states: Sequence[TrainState], rows: Sequence[GridRow], enc_hidden: Sequence[int],
              dec_hidden: Sequence[int], dual: bool = False):
    """The rows' states → three flat buffers (params, m, v), row i's flat
    ``pack_state`` at ``row_offsets(...)[i]``."""
    packed = [pack_state(s, *row_widths(r, enc_hidden, dec_hidden), dual)
              for s, r in zip(states, rows)]
    return tuple(torch.cat([bufs[j] for bufs in packed]) for j in range(3))


def row_views(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, rows: Sequence[GridRow],
              enc_hidden: Sequence[int], dec_hidden: Sequence[int], dual: bool = False):
    """Row i's (p, m, v) slices of the packed buffers, as views."""
    offs = row_offsets(rows, enc_hidden, dec_hidden, dual)
    return [tuple(t[offs[i]:offs[i + 1]] for t in (p, m, v)) for i in range(len(rows))]


def unpack_rows(states: Sequence[TrainState], p: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, rows: Sequence[GridRow], n_steps: int,
                enc_hidden: Sequence[int], dec_hidden: Sequence[int],
                dual: bool = False) -> List[TrainState]:
    """Copy the packed buffers back into each row's state by name and
    advance its counters by ``n_steps``."""
    views = row_views(p, m, v, rows, enc_hidden, dec_hidden, dual)
    return [unpack_state(s, *bufs, n_steps, *row_widths(r, enc_hidden, dec_hidden), dual)
            for s, bufs, r in zip(states, views, rows)]


def run_grid_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                   rows: Sequence[GridRow], *, n_steps: int, batch: int,
                   enc_hidden: Sequence[int], dec_hidden: Sequence[int], kind: str,
                   eps_const: float, tdv: bool, lr: float, dual: bool = False,
                   external_noise: Optional[Sequence[Noise]] = None,
                   adam_dtype: str = "f32", bf16_dots: bool = False) -> torch.Tensor:
    """K6b: train every row ``n_steps`` steps from the packed state
    (``pack_rows``), in place, in one launch. Returns the (rows, n_steps)
    losses. Row i runs what ``run_mlp_fused_chunk`` runs on its slice with
    its ``GridRow`` and the widths (D, *enc_hidden, L) and
    (L, *dec_hidden, D); batch, the hidden widths, the manifold kind, ε,
    -tdv, lr, the decoder head, the moment dtype and the dot mode are the
    launch's. ``external_noise``, one (x, z1, z2) a row, replaces the
    in-kernel sampler (the test hook)."""
    kw = dict(n_steps=n_steps, batch=batch, enc_hidden=enc_hidden, dec_hidden=dec_hidden,
              kind=kind, eps_const=eps_const, tdv=tdv, lr=lr, dual=dual,
              external_noise=external_noise, adam_dtype=adam_dtype, bf16_dots=bf16_dots)
    if p.device.type == "cpu":
        return plain_grid_chunk(p, m, v, rows, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"run_grid_chunk takes CPU or CUDA tensors, got {p.device}")
    if not rows:
        raise ValueError("run_grid_chunk needs at least one row")
    total = row_offsets(rows, enc_hidden, dec_hidden, dual)[-1]
    for t, name in ((p, "p"), (m, "m"), (v, "v")):
        _require(t, name, p.device, (total,))
    losses = torch.empty(len(rows), n_steps, dtype=torch.float32, device=p.device)
    if n_steps == 0:
        return losses
    _launch(row_views(p, m, v, rows, enc_hidden, dec_hidden, dual), losses, rows, **kw)
    run_grid_chunk.launches += 1
    return losses


run_grid_chunk.launches = 0


def plain_grid_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     rows: Sequence[GridRow], *, n_steps: int, batch: int,
                     enc_hidden: Sequence[int], dec_hidden: Sequence[int], kind: str,
                     eps_const: float, tdv: bool, lr: float, dual: bool = False,
                     external_noise: Optional[Sequence[Noise]] = None,
                     adam_dtype: str = "f32", bf16_dots: bool = False) -> torch.Tensor:
    """The plain PyTorch version of ``run_grid_chunk``: one
    ``plain_mlp_fused_chunk`` per row on its slice of the packed buffers,
    same signature, same in-place contract."""
    plain_grid_chunk.calls += 1
    losses = torch.empty(len(rows), n_steps, dtype=torch.float32, device=p.device)
    views = row_views(p, m, v, rows, enc_hidden, dec_hidden, dual)
    for i, (r, (rp, rm, rv)) in enumerate(zip(rows, views)):
        enc, dec = row_widths(r, enc_hidden, dec_hidden)
        losses[i] = plain_mlp_fused_chunk(
            rp, rm, rv, r.a, n_steps=n_steps, batch=batch, enc_widths=enc, dec_widths=dec,
            kind=kind, intrinsic_dim=r.intrinsic_dim, manifold_dim=r.manifold_dim,
            step0=r.step0, t0=r.t0, data_seed=r.data_seed, model_seed=r.model_seed,
            var_added=r.var_added, eps_const=eps_const, tdv=tdv, lr=lr,
            external_noise=None if external_noise is None else external_noise[i], dual=dual,
            adam_dtype=adam_dtype, bf16_dots=bf16_dots)
    return losses


plain_grid_chunk.calls = 0  # chunks run by the plain version (the CPU tests read it)


def make_grid_chunk(models: Sequence, datasets: Sequence, cfg):
    """The grid trainers' ``chunk(states, n_steps, noises=None)`` on K6b:
    one launch per chunk over every row (``grid_supported`` said yes).
    Returns (states, (rows, n_steps) losses)."""
    model = models[0]
    dual = model.dual_sigmoid_decoder
    kind = dataset_kind(datasets[0])
    enc_hidden, dec_hidden = model.encoder_features[:-1], model.decoder_features[:-1]
    arrays = [d.A.contiguous() if kind != "sphere" else None for d in datasets]
    lr = float(cfg.learning_rate)

    def chunk(states: Sequence[TrainState], n_steps: int,
              noises: Optional[Sequence[Noise]] = None):
        with span("chunk.pack"):
            rows = [GridRow(d.dimension, mdl.latent_dim, d.intrinsic_dim, d.dim, a, s.step,
                            s.count, s.data_seed, s.model_seed, d.var_added)
                    for mdl, d, a, s in zip(models, datasets, arrays, states)]
            p, m, v = pack_rows(states, rows, enc_hidden, dec_hidden, dual)
        with span("chunk.launch"):
            losses = run_grid_chunk(p, m, v, rows, n_steps=n_steps, batch=cfg.batch_size,
                                    enc_hidden=enc_hidden, dec_hidden=dec_hidden, kind=kind,
                                    eps_const=model.epsilon_const, tdv=model.tunable_decoder_var,
                                    lr=lr, dual=dual, external_noise=noises,
                                    adam_dtype=cfg.adam_dtype, bf16_dots=model.bf16_dots)
        with span("chunk.unpack"):
            states = unpack_rows(states, p, m, v, rows, n_steps, enc_hidden, dec_hidden, dual)
        return states, losses

    return chunk
