"""K5: the fused MLP-VAE training chunk — CUDA wrapper and plain version.

Port of ``vae_training_tpu/kernels/mlp_vae.py`` in solo mode
(``run_mlp_fused_chunk`` → ``_make_kernel``, the ``pl.pallas_call`` at
``:644``) for the sphere and linear_gaussian manifolds with one decoder: the
sphere sweep's 200|200|200 ReLU stacks, and MLPs on linear_gaussian. The
kernel itself is ``csrc/mlp_vae.cu``: one persistent cooperative launch runs
a whole K-step chunk (sampling, forward through both stacks, closed-form
ELBO, backward through every layer, Adam), its phases separated by grid-wide
barriers, the state in the caller's buffers and the activations in one
scratch buffer the wrapper allocates.

The state crosses the launch as three flat float32 buffers (params, Adam
m, Adam v) in the layout of ``param_layout``: every Dense layer of the
encoder, then of the decoder (flax names, ``kernel`` (in, out) then
``bias``), then ``epsilon_p`` and ``epsilon``. With one layer per stack
this is K1's layout. ``run_mlp_fused_chunk`` updates the buffers in place
and returns the per-step losses.

``run_mlp_fused_chunk`` launches the kernel for CUDA tensors and raises if
it cannot; for CPU tensors (and only for them) it runs
``plain_mlp_fused_chunk``, the same chunk on the torch path behind the same
signature. ``run_mlp_fused_chunk.launches`` counts kernel launches. The
sigmoid dataset's dual-decoder MLPs (``mlp_vae.py:308-311, 324-329,
349-352``) are not ported yet: ``supported`` refuses them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import rng
from ..train.state import TrainState
from ..train.step import Noise
from .linear_vae import (
    Layout,
    _require,
    cuda_device_ok,
    pack_layout,
    run_plain_chunk,
    unpack_layout_,
)

THREADS = 512  # the kernel's block size (kThreads in csrc/mlp_vae.cu)
MAX_LAYERS = 8  # Dense layers per stack (kMaxLayers)
KINDS = {"sphere": 0, "linear": 1}  # the manifolds K5 samples in-kernel


def stack_widths(model) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(encoder widths, decoder widths) of a model, inputs included:
    (D, h₁, …, L) and (L, h₁, …, D)."""
    return ((model.data_dim,) + model.encoder_features,
            (model.latent_dim,) + model.decoder_features)


def param_layout(enc_widths: Sequence[int], dec_widths: Sequence[int]) -> Layout:
    """Flat order of the state buffers (csrc/mlp_vae.cu agrees)."""
    layout = []
    for group, w in (("Encoder", enc_widths), ("Decoder", dec_widths)):
        for i in range(len(w) - 1):
            layout += [(f"{group}.FC{i}.kernel", (w[i], w[i + 1])),
                       (f"{group}.FC{i}.bias", (w[i + 1],))]
    return layout + [("epsilon_p", (enc_widths[-1],)), ("epsilon", (1,))]


def n_params(enc_widths: Sequence[int], dec_widths: Sequence[int]) -> int:
    return sum(int(np.prod(s)) for _, s in param_layout(enc_widths, dec_widths))


def pack_state(state: TrainState, enc_widths, dec_widths):
    layout = param_layout(enc_widths, dec_widths)
    return tuple(pack_layout(d, layout) for d in (state.params, state.m, state.v))


def unpack_state(state: TrainState, p, m, v, n_steps: int, enc_widths,
                 dec_widths) -> TrainState:
    layout = param_layout(enc_widths, dec_widths)
    for flat, d in ((p, state.params), (m, state.m), (v, state.v)):
        unpack_layout_(flat, d, layout)
    state.step += n_steps
    state.count += n_steps
    return state


def dataset_kind(dataset) -> Optional[str]:
    from ..data.synthetic import LinearGaussianDataset, SphereDataset

    if isinstance(dataset, SphereDataset):
        return "sphere"
    if isinstance(dataset, LinearGaussianDataset):
        return "linear"
    return None


def supported(model, dataset, cfg) -> Tuple[bool, str]:
    """Whether K5 can run this configuration (the counterpart of
    ``mlp_pallas_supported``, ``mlp_vae.py:682-724``, re-derived for the
    card): ReLU stacks with a hidden layer in at least one of them (pure
    linear nets take the linear kernel), the sphere or linear_gaussian
    dataset without the dual decoder, at most ``MAX_LAYERS`` layers a stack,
    and a CUDA device of compute capability 9.0. The TPU kernel's
    batch ≤ 128 and widths ≤ 512 were VMEM and lane limits and do not apply:
    the state lives in device memory."""
    from ..data.synthetic import SigmoidDataset

    kind = dataset_kind(dataset)
    if isinstance(dataset, SigmoidDataset):
        return False, ("the MLP kernel's sigmoid dual-decoder branch is not "
                       "ported yet (ROADMAP Queue 2 item 2)")
    if kind is None:
        return False, "the MLP kernel supports the sphere and linear_gaussian datasets"
    if model.dual_sigmoid_decoder:
        return False, "the dual decoder expects the sigmoid dataset"
    enc, dec = stack_widths(model)
    if len(enc) < 3 and len(dec) < 3:
        return False, "pure-linear configs use the linear kernel"
    if max(len(enc), len(dec)) - 1 > MAX_LAYERS:
        return False, f"the MLP kernel takes at most {MAX_LAYERS} layers a stack"
    ok, why = cuda_device_ok(cfg)
    if not ok:
        return False, why
    return True, (f"ReLU MLP VAE on {'sphere' if kind == 'sphere' else 'linear_gaussian'}, "
                  f"{n_params(enc, dec)} parameters")


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ._build import load_library

        lib = load_library("mlp_vae")[0]
        vp, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        i64, ip = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
        lib.mlp_vae_chunk.argtypes = (
            [vp] * 5 + [i64] + [vp] * 4 + [i32] * 7 + [i32, ip, i32, ip]
            + [u32, i32, u32, u32, u32, u32, f32, f32, i32, f32, vp])
        lib.mlp_vae_chunk.restype = i32
        lib.mlp_vae_scratch_floats.argtypes = [i32] * 7 + [ip, i32, ip]
        lib.mlp_vae_scratch_floats.restype = i64
        lib.mlp_vae_grid.argtypes = [ip, ip]
        lib.mlp_vae_grid.restype = i32
        lib.mlp_vae_error_string.argtypes = [i32]
        lib.mlp_vae_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.mlp_vae_error_string(err).decode()})")


def _int_array(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)


def grid() -> Tuple[int, int]:
    """(blocks of a launch, the most blocks an SM could hold) on the
    current device: the kernel launches one block per SM."""
    lib = _lib()
    blocks, occ = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib, lib.mlp_vae_grid(ctypes.byref(blocks), ctypes.byref(occ)), "mlp_vae_grid")
    return blocks.value, occ.value


def run_mlp_fused_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                        a: Optional[torch.Tensor], *, n_steps: int, batch: int,
                        enc_widths: Sequence[int], dec_widths: Sequence[int],
                        kind: str, intrinsic_dim: int, manifold_dim: int,
                        step0: int, t0: int, data_seed: int, model_seed: int,
                        var_added: float, eps_const: float, tdv: bool, lr: float,
                        external_noise: Optional[Noise] = None) -> torch.Tensor:
    """Train ``n_steps`` steps from the flat state (p, m, v), in place.
    Returns the (n_steps,) losses. ``kind`` is "sphere" (``a`` unused,
    intrinsic_dim = manifold_dim) or "linear" (``a`` is A, manifold_dim ×
    intrinsic_dim). ``enc_widths`` = (D, h₁, …, L) and ``dec_widths`` =
    (L, h₁, …, D). ``step0`` is the absolute step of the first step (the
    Philox counter) and ``t0`` the Adam count before it. ``external_noise``
    = (x, z1, z2), each (n_steps, batch, dim), replaces the in-kernel
    sampler (the test hook of the TPU kernel)."""
    kw = dict(n_steps=n_steps, batch=batch, enc_widths=enc_widths,
              dec_widths=dec_widths, kind=kind, intrinsic_dim=intrinsic_dim,
              manifold_dim=manifold_dim, step0=step0, t0=t0, data_seed=data_seed,
              model_seed=model_seed, var_added=var_added, eps_const=eps_const,
              tdv=tdv, lr=lr, external_noise=external_noise)
    if p.device.type == "cpu":
        return plain_mlp_fused_chunk(p, m, v, a, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"run_mlp_fused_chunk takes CPU or CUDA tensors, got {p.device}")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    enc, dec = tuple(enc_widths), tuple(dec_widths)
    D, L, B = enc[0], enc[-1], batch
    if dec[0] != L or dec[-1] != D:
        raise ValueError(f"stacks do not chain: encoder {enc}, decoder {dec}")
    if not 1 <= max(len(enc), len(dec)) - 1 <= MAX_LAYERS or min(len(enc), len(dec)) < 2:
        raise ValueError(f"each stack takes 1..{MAX_LAYERS} layers: {enc}, {dec}")
    device = p.device
    P = n_params(enc, dec)
    for t, name in ((p, "p"), (m, "m"), (v, "v")):
        _require(t, name, device, (P,))
    a_ptr = None
    if kind == "linear":
        _require(a, "a", device, (manifold_dim, intrinsic_dim))
        a_ptr = a.data_ptr()
    elif intrinsic_dim != manifold_dim or var_added > 0:
        raise ValueError("the sphere draws intrinsic_dim = manifold_dim normals and "
                         "has no observation noise")
    ext = [None, None, None]
    if external_noise is not None:
        for i, (t, name, dim) in enumerate(zip(external_noise, ("x", "z1", "z2"), (D, L, D))):
            _require(t, f"external_noise {name}", device, (n_steps, B, dim))
            ext[i] = t.data_ptr()
    losses = torch.empty(n_steps, dtype=torch.float32, device=device)
    if n_steps == 0:
        return losses
    lib = _lib()
    enc_arr, dec_arr = _int_array(enc), _int_array(dec)
    shape = (B, D, L, intrinsic_dim, manifold_dim, KINDS[kind])
    n_scratch = lib.mlp_vae_scratch_floats(*shape, len(enc) - 1, enc_arr,
                                           len(dec) - 1, dec_arr)
    if n_scratch < 0:
        raise ValueError(f"the kernel refuses these shapes: batch {B}, encoder {enc}, "
                         f"decoder {dec}, intrinsic {intrinsic_dim}, manifold {manifold_dim}")
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=device)
    dk = rng.key_words(data_seed)
    mk = rng.key_words(model_seed)
    obs_scale = float(np.sqrt(np.float32(var_added))) if var_added > 0 else 0.0
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.mlp_vae_chunk(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), losses.data_ptr(), scratch.data_ptr(),
        n_scratch, a_ptr, *ext, n_steps, *shape, len(enc) - 1, enc_arr,
        len(dec) - 1, dec_arr, step0 & rng.MASK32, t0, dk[0], dk[1], mk[0], mk[1],
        obs_scale, float(eps_const), int(bool(tdv)), float(lr), stream)
    _check(lib, err, "mlp_vae_chunk launch")
    run_mlp_fused_chunk.launches += 1
    return losses


run_mlp_fused_chunk.launches = 0


def plain_mlp_fused_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                          a: Optional[torch.Tensor], *, n_steps: int, batch: int,
                          enc_widths: Sequence[int], dec_widths: Sequence[int],
                          kind: str, intrinsic_dim: int, manifold_dim: int,
                          step0: int, t0: int, data_seed: int, model_seed: int,
                          var_added: float, eps_const: float, tdv: bool, lr: float,
                          external_noise: Optional[Noise] = None) -> torch.Tensor:
    """The plain PyTorch version of ``run_mlp_fused_chunk``: the same chunk
    on the torch path (autograd + the explicit Adam update), same signature,
    same in-place contract."""
    from ..data.synthetic import LinearGaussianDataset, SphereDataset
    from ..models.networks import build_vae

    enc, dec = tuple(enc_widths), tuple(dec_widths)
    D, L = enc[0], enc[-1]
    model = build_vae(data_dim=D, latent_dim=L,
                      encoder_layer_sizes="|".join(map(str, enc[1:-1])),
                      decoder_layer_sizes="|".join(map(str, dec[1:-1])),
                      epsilon=eps_const, tunable_decoder_var=tdv)
    if kind == "sphere":
        dataset = SphereDataset(manifold_dim, D - manifold_dim, device=p.device)
    else:
        dataset = LinearGaussianDataset(a, manifold_dim, intrinsic_dim,
                                        D - manifold_dim, var_added)
    return run_plain_chunk(p, m, v, param_layout(enc, dec), model, dataset,
                           n_steps=n_steps, batch=batch, step0=step0, t0=t0,
                           data_seed=data_seed, model_seed=model_seed, tdv=tdv,
                           lr=lr, external_noise=external_noise)


def make_train_chunk(model, dataset, cfg):
    """The Trainer's ``train_chunk(state, n_steps)`` on K5."""
    enc, dec = stack_widths(model)
    kind = dataset_kind(dataset)
    a = dataset.A.contiguous() if kind == "linear" else None
    lr = float(cfg.learning_rate)

    def train_chunk(state: TrainState, n_steps: int, noise: Optional[Noise] = None):
        p, m, v = pack_state(state, enc, dec)
        losses = run_mlp_fused_chunk(
            p, m, v, a, n_steps=n_steps, batch=cfg.batch_size, enc_widths=enc,
            dec_widths=dec, kind=kind, intrinsic_dim=dataset.intrinsic_dim,
            manifold_dim=dataset.dim, step0=state.step, t0=state.count,
            data_seed=state.data_seed, model_seed=state.model_seed,
            var_added=dataset.var_added, eps_const=model.epsilon_const,
            tdv=model.tunable_decoder_var, lr=lr, external_noise=noise)
        return unpack_state(state, p, m, v, n_steps, enc, dec), losses

    return train_chunk
