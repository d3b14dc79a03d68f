"""Warm-start analytic initializers (``-ws``).

Port of ``vae_training_tpu/models/warm_start.py:23-150``, on the port's
parameter dicts (dotted flax names; kernels in flax's (in, out) layout, as
``runio/export.py`` maps them, so each kernel is written exactly as the JAX
package writes it). The means follow the reference's formulas; the
perturbations are i.i.d. normals, four draws a function, from the Philox
streams keyed by the run's warm-start seed
(``rng.derive_seed(model_seed, rng.SEED_WARM_START)``): draw ``i`` is the
counter step ``i``. ``draws=`` replaces them with the caller's four arrays,
in the JAX function's key order (the parity tests pass the JAX package's
own draws). ``pinv(A)`` runs in numpy on the host, as in the JAX package.

Both initializers only make sense for pure-linear encoders and decoders
(they write the ``FC0`` kernels), as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import rng


def perturbations(seed: int, shapes: Sequence[tuple]) -> list:
    """One float32 numpy array of standard normals a shape, draw ``i`` at
    counter step ``i`` of the streams keyed ``seed``."""
    out = []
    for i, shape in enumerate(shapes):
        rows, cols = (1, shape[0]) if len(shape) == 1 else shape
        n = rng.normals(seed, i, rows, rng.STREAM_MANIFOLD, cols, device="cpu")
        out.append(n.numpy().reshape(shape))
    return out


def _draws(seed: Optional[int], draws, shapes) -> list:
    if draws is None:
        return perturbations(seed, shapes)
    draws = [np.asarray(d, np.float32) for d in draws]
    got = [d.shape for d in draws]
    if got != [tuple(s) for s in shapes]:
        raise ValueError(f"draws must have the shapes {list(shapes)}, got {got}")
    return draws


def _with(params: dict, arrays: dict) -> dict:
    """A new dict: ``params`` with the named leaves replaced (float32, on
    the device of the leaves they replace)."""
    new = dict(params)
    for name, a in arrays.items():
        new[name] = torch.as_tensor(np.asarray(a, np.float32), device=params[name].device)
    return new


def warm_start_sigmoid(params: dict, dataset, latent_dim: int, seed: Optional[int] = None,
                       draws=None) -> dict:
    """Identity encoder/decoder restricted to the manifold dimensions.

    Requires latent_dim == ambient dimension. The decoder and encoder
    kernels start as the identity with the block acting on the padding
    dimensions zeroed, the SigDecoder's at small noise; the posterior
    log-variance starts at 0 on the manifold dimensions and -3 on the
    padding. ``draws``: (decoder (L, D), SigDecoder (L, D), epsilon_p (L,),
    encoder (D, L))."""
    data_dim = dataset.dimension
    if latent_dim != data_dim:
        raise ValueError(
            "sigmoid warm start requires latent_dim == dataset dimension "
            f"(got {latent_dim} vs {data_dim})"
        )
    cut = dataset.dim + 1  # manifold coords: z (dim) + sigma coordinate
    n_dec, n_sig, n_epsp, n_enc = _draws(seed, draws, [
        (latent_dim, data_dim), (latent_dim, data_dim), (latent_dim,),
        (data_dim, latent_dim)])
    blocked_eye = np.eye(latent_dim, dtype=np.float32)
    blocked_eye[cut:, cut:] = 0.0
    eps_p = np.zeros((latent_dim,), np.float32)
    eps_p[cut:] = -3.0
    return _with(params, {"Decoder.FC0.kernel": blocked_eye + 0.1 * n_dec,
                          "SigDecoder.FC0.kernel": 0.1 * n_sig,
                          "Encoder.FC0.kernel": blocked_eye + 0.1 * n_enc,
                          "epsilon_p": eps_p + 0.1 * n_epsp})


def warm_start_linear_gaussian(params: dict, dataset, latent_dim: int,
                               latent_off_dimension: int, seed: Optional[int] = None,
                               pinv=None, draws=None) -> dict:
    """Decoder ← [A | extra | 0] (plus padding rows), encoder ← pinv(A).

    ``latent_off_dimension`` extra random decoder columns model the
    off-manifold latent directions; the posterior log-variance starts at -3
    on the first intrinsic + off dimensions and 0 elsewhere. ``pinv``: A's
    pseudo-inverse if the caller has it. ``draws``: (extra (dim, off),
    decoder (D, L), encoder (L, D), epsilon_p (L,))."""
    data_dim = dataset.dimension
    if not dataset.dim + latent_off_dimension < latent_dim:
        raise ValueError(
            "linear warm start requires dataset dim + latent_off_dimension "
            f"< latent_dim (got {dataset.dim} + {latent_off_dimension} vs "
            f"{latent_dim})"
        )
    A = dataset.A.detach().cpu().numpy()  # (dim, intrinsic_dim), float32
    intrinsic = A.shape[1]
    n_extra, n_dec, n_enc, n_epsp = _draws(seed, draws, [
        (dataset.dim, latent_off_dimension), (data_dim, latent_dim),
        (latent_dim, data_dim), (latent_dim,)])
    zero_cols = np.zeros((dataset.dim, latent_dim - dataset.dim - latent_off_dimension),
                         np.float32)
    dec_top = np.concatenate([A, n_extra, zero_cols], axis=1)
    # Width is latent_dim + (intrinsic - dim); equal widths require
    # intrinsic == dim, the reference's implicit precondition.
    if dec_top.shape[1] != latent_dim:
        raise ValueError(
            "linear warm start requires intrinsic dimension == dataset "
            f"dimension (A has {intrinsic} columns, dataset dim {dataset.dim})"
        )
    dec_pad_rows = np.zeros((data_dim - dataset.dim, latent_dim), np.float32)
    dec_const = np.concatenate([dec_top, dec_pad_rows], axis=0) + 0.01 * n_dec  # (D, L)
    if pinv is None:
        pinv = np.linalg.pinv(A)
    enc_const = np.zeros((latent_dim, data_dim), np.float32)  # (L, D)
    enc_const[:intrinsic, :dataset.dim] = np.asarray(pinv, np.float32)
    enc_const = enc_const + 0.01 * n_enc
    eps_p = np.zeros((latent_dim,), np.float32)
    eps_p[:intrinsic + latent_off_dimension] = -3.0
    # flax kernels are (in, out): decoder (L, D) = dec_constᵀ, encoder
    # (D, L) = enc_constᵀ
    return _with(params, {"Decoder.FC0.kernel": dec_const.T, "Encoder.FC0.kernel": enc_const.T,
                          "epsilon_p": eps_p + 0.1 * n_epsp})


def apply_warm_start(params: dict, dataset_name: str, dataset, latent_dim: int,
                     latent_off_dimension: int, seed: Optional[int] = None, pinv=None,
                     draws=None) -> dict:
    """The dataset's warm start (sigmoid, linear_gaussian); ``params``
    unchanged for any other dataset."""
    if dataset_name == "sigmoid":
        return warm_start_sigmoid(params, dataset, latent_dim, seed, draws=draws)
    if dataset_name == "linear_gaussian":
        return warm_start_linear_gaussian(params, dataset, latent_dim, latent_off_dimension,
                                          seed, pinv=pinv, draws=draws)
    return params
