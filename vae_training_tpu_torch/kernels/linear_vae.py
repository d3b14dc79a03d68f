"""K1: the fused linear-VAE training chunk — CUDA wrapper and plain version.

Port of ``vae_training_tpu/kernels/linear_vae.py`` in solo mode on the
linear_gaussian dataset (``run_fused_chunk`` → ``_make_kernel``, the
``pl.pallas_call`` at ``:678``). The kernel itself is
``csrc/linear_vae.cu``: one launch runs a whole K-step chunk (sampling,
forward, closed-form ELBO, analytic backward, Adam) with the state resident
in one CTA's shared memory.

The state crosses the launch as three flat float32 buffers (params, Adam
m, Adam v) in the layout of ``param_layout``: flax names, true dimensions,
no TPU lane padding. ``run_fused_chunk`` updates them in place and returns
the per-step losses.

``run_fused_chunk`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors (and only for them) it runs ``plain_fused_chunk``,
the same chunk on the torch path (``train/step.py``) behind the same
signature, whose autograd backward checks the kernel's hand-derived one.
``run_fused_chunk.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import rng
from ..train.state import TrainState
from ..train.step import Noise, train_chunk as torch_train_chunk

THREADS = 256  # the kernel's CTA size (kThreads in csrc/linear_vae.cu)
# Dynamic shared memory a block may opt into on sm_90 (227 KB).
SMEM_LIMIT = 232448
# compute capability the kernel is built for (sm_90a)
CAPABILITY = (9, 0)


def param_layout(data_dim: int, latent_dim: int) -> List[Tuple[str, tuple]]:
    """Flat order of the state buffers (csrc/linear_vae.cu agrees). The
    ``epsilon`` slot is always present; without -tdv its gradient is zero,
    so Adam leaves it unchanged and unpacking ignores it."""
    D, L = data_dim, latent_dim
    return [("Encoder.FC0.kernel", (D, L)), ("Encoder.FC0.bias", (L,)),
            ("Decoder.FC0.kernel", (L, D)), ("Decoder.FC0.bias", (D,)),
            ("epsilon_p", (L,)), ("epsilon", (1,))]


def n_params(data_dim: int, latent_dim: int) -> int:
    return 2 * data_dim * latent_dim + 2 * latent_dim + data_dim + 1


def smem_bytes(batch: int, data_dim: int, latent_dim: int, intrinsic_dim: int,
               manifold_dim: int) -> int:
    """Shared memory of one launch (mirrors smem_floats in the .cu file):
    params, m, v and grads; A and e^{ep/2}; eight per-step activation
    buffers; the reduction scratch."""
    D, L, B = data_dim, latent_dim, batch
    floats = (4 * n_params(D, L) + manifold_dim * intrinsic_dim + L
              + B * (intrinsic_dim + 4 * L + 3 * D) + 3 * (THREADS // 32))
    return 4 * floats


def pack(tensors, data_dim: int, latent_dim: int) -> torch.Tensor:
    """Dict of named tensors → one flat (P,) float32 buffer."""
    parts = []
    for name, shape in param_layout(data_dim, latent_dim):
        t = tensors.get(name)
        if t is None:  # epsilon without -tdv
            ref = next(iter(tensors.values()))
            t = torch.zeros(shape, dtype=torch.float32, device=ref.device)
        parts.append(t.reshape(-1).to(torch.float32))
    return torch.cat(parts).contiguous()


def unpack_(flat: torch.Tensor, tensors, data_dim: int, latent_dim: int) -> None:
    """Copy a flat buffer back into the named tensors, in place."""
    off = 0
    for name, shape in param_layout(data_dim, latent_dim):
        n = int(np.prod(shape))
        if name in tensors:
            tensors[name].copy_(flat[off:off + n].view(shape))
        off += n


def pack_state(state: TrainState, data_dim: int, latent_dim: int):
    return tuple(pack(d, data_dim, latent_dim)
                 for d in (state.params, state.m, state.v))


def unpack_state(state: TrainState, p, m, v, n_steps: int, data_dim: int,
                 latent_dim: int) -> TrainState:
    for flat, d in ((p, state.params), (m, state.m), (v, state.v)):
        unpack_(flat, d, data_dim, latent_dim)
    state.step += n_steps
    state.count += n_steps
    return state


def supported(model, dataset, cfg) -> Tuple[bool, str]:
    """Whether K1 can run this configuration (the counterpart of
    ``pallas_supported``, ``linear_vae.py:823-858``, re-derived for the
    card): a pure-linear encoder and decoder, the linear_gaussian dataset,
    a CUDA device of compute capability 9.0, and a state plus per-step
    activations that fit one block's shared memory. The TPU kernel's
    batch ≤ 128 and dims ≤ 128 were lane limits and do not apply."""
    from ..data.synthetic import LinearGaussianDataset

    if not isinstance(dataset, LinearGaussianDataset):
        return False, "the fused kernel supports the linear_gaussian dataset"
    if (model.encoder_features != (model.latent_dim,)
            or model.decoder_features != (dataset.dimension,)):
        return False, "the fused kernel supports 0-hidden-layer (pure linear) nets"
    need = smem_bytes(cfg.batch_size, dataset.dimension, model.latent_dim,
                      dataset.intrinsic_dim, dataset.dim)
    if need > SMEM_LIMIT:
        return False, (f"state and activations need {need} B of shared memory, "
                       f"above the {SMEM_LIMIT} B a block may use")
    device = torch.device(cfg.device)
    if device.type != "cuda":
        return False, f"device {cfg.device!r} is not a CUDA device"
    if not torch.cuda.is_available():
        return False, "no CUDA device is available"
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != CAPABILITY:
        return False, f"the kernel is built for sm_90a; this device is sm_{cap[0]}{cap[1]}"
    return True, f"pure-linear VAE on linear_gaussian, {need} B of shared memory"


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ._build import load_library

        lib = load_library("linear_vae")[0]
        vp, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.linear_vae_chunk.argtypes = (
            [vp] * 8 + [i32] * 6 + [u32, i32, u32, u32, u32, u32, f32, f32, i32, f32, vp])
        lib.linear_vae_chunk.restype = i32
        lib.philox_normals.argtypes = [vp, vp, i32, i32, u32, u32, u32, u32, vp]
        lib.philox_normals.restype = i32
        lib.linear_vae_smem_bytes.argtypes = [i32] * 5
        lib.linear_vae_smem_bytes.restype = ctypes.c_size_t
        lib.linear_vae_error_string.argtypes = [i32]
        lib.linear_vae_error_string.restype = ctypes.c_char_p
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
                    external_noise: Optional[Noise] = None) -> torch.Tensor:
    """Train ``n_steps`` steps from the flat state (p, m, v), in place.
    Returns the (n_steps,) losses. ``a`` is the manifold matrix A
    (manifold_dim × intrinsic_dim); ``step0`` is the absolute step of the
    first step (the Philox counter) and ``t0`` the Adam count before it.
    ``external_noise`` = (x, z1, z2), each (n_steps, batch, dim), replaces
    the in-kernel sampler (the test hook of the TPU kernel)."""
    kw = dict(n_steps=n_steps, batch=batch, data_dim=data_dim,
              latent_dim=latent_dim, intrinsic_dim=intrinsic_dim,
              manifold_dim=manifold_dim, step0=step0, t0=t0,
              data_seed=data_seed, model_seed=model_seed, var_added=var_added,
              eps_const=eps_const, tdv=tdv, lr=lr, external_noise=external_noise)
    if p.device.type == "cpu":
        return plain_fused_chunk(p, m, v, a, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"run_fused_chunk takes CPU or CUDA tensors, got {p.device}")
    D, L, B = data_dim, latent_dim, batch
    device = p.device
    P = n_params(D, L)
    for t, name in ((p, "p"), (m, "m"), (v, "v")):
        _require(t, name, device, (P,))
    _require(a, "a", device, (manifold_dim, intrinsic_dim))
    need = smem_bytes(B, D, L, intrinsic_dim, manifold_dim)
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
        *ext, n_steps, B, D, L, intrinsic_dim, manifold_dim,
        step0 & rng.MASK32, t0, dk[0], dk[1], mk[0], mk[1], obs_scale,
        float(eps_const), int(bool(tdv)), float(lr), stream)
    _check(lib, err, "linear_vae_chunk launch")
    run_fused_chunk.launches += 1
    return losses


run_fused_chunk.launches = 0


def plain_fused_chunk(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      a: torch.Tensor, *, n_steps: int, batch: int, data_dim: int,
                      latent_dim: int, intrinsic_dim: int, manifold_dim: int,
                      step0: int, t0: int, data_seed: int, model_seed: int,
                      var_added: float, eps_const: float, tdv: bool, lr: float,
                      external_noise: Optional[Noise] = None) -> torch.Tensor:
    """The plain PyTorch version of ``run_fused_chunk``: the same chunk on
    the torch path (autograd + the explicit Adam update), same signature,
    same in-place contract."""
    from ..data.synthetic import LinearGaussianDataset
    from ..models.networks import build_vae

    D, L = data_dim, latent_dim
    model = build_vae(data_dim=D, latent_dim=L, epsilon=eps_const,
                      tunable_decoder_var=tdv)
    dataset = LinearGaussianDataset(a, manifold_dim, intrinsic_dim,
                                    D - manifold_dim, var_added)

    def unflat(flat):
        d = {name: torch.empty(shape, device=flat.device)
             for name, shape in param_layout(D, L) if tdv or name != "epsilon"}
        unpack_(flat, d, D, L)
        return d

    state = TrainState(params=unflat(p), m=unflat(m), v=unflat(v), count=t0,
                       step=step0, data_seed=data_seed, model_seed=model_seed)
    state, losses = torch_train_chunk(model, dataset, state, n_steps,
                                      batch_size=batch, lr=lr,
                                      noise=external_noise)
    for flat, d in ((p, state.params), (m, state.m), (v, state.v)):
        # without -tdv the epsilon slot is not in d and stays as it was
        n = flat.numel() - (0 if tdv else 1)
        flat[:n].copy_(pack(d, D, L)[:n])
    return losses


def make_train_chunk(model, dataset, cfg):
    """The Trainer's ``train_chunk(state, n_steps)`` on K1."""
    D, L = dataset.dimension, model.latent_dim
    a = dataset.A.contiguous()
    lr = float(cfg.learning_rate)

    def train_chunk(state: TrainState, n_steps: int, noise: Optional[Noise] = None):
        p, m, v = pack_state(state, D, L)
        losses = run_fused_chunk(
            p, m, v, a, n_steps=n_steps, batch=cfg.batch_size, data_dim=D,
            latent_dim=L, intrinsic_dim=dataset.intrinsic_dim,
            manifold_dim=dataset.dim, step0=state.step, t0=state.count,
            data_seed=state.data_seed, model_seed=state.model_seed,
            var_added=dataset.var_added, eps_const=model.epsilon_const,
            tdv=model.tunable_decoder_var, lr=lr, external_noise=noise)
        return unpack_state(state, p, m, v, n_steps, D, L), losses

    return train_chunk


def sampler_check(rows: int, n_draws: int, step: int, stream_id: int, seed: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's raw sampler on the card: (rows, n_draws, 4) words (as
    int64) and normals at counters (step, row, draw, stream_id) — the
    bitwise check of the in-kernel Philox against ``ops/rng.py``."""
    lib = _lib()
    words = torch.empty(rows, n_draws, 4, dtype=torch.int32, device=device)
    normals = torch.empty(rows, n_draws, 4, dtype=torch.float32, device=device)
    k0, k1 = rng.key_words(seed)
    err = lib.philox_normals(words.data_ptr(), normals.data_ptr(), rows, n_draws,
                             step & rng.MASK32, stream_id, k0, k1,
                             torch.cuda.current_stream(device).cuda_stream)
    _check(lib, err, "philox_normals launch")
    return words.to(torch.int64) & rng.MASK32, normals


def kernel_smem_bytes(batch: int, data_dim: int, latent_dim: int,
                      intrinsic_dim: int, manifold_dim: int) -> int:
    """The library's own shared-memory figure (to hold ``smem_bytes`` to it)."""
    return int(_lib().linear_vae_smem_bytes(batch, data_dim, latent_dim,
                                            intrinsic_dim, manifold_dim))
