"""The reference VAE as ``torch.nn.Module``s, with flax names and layouts.

Port of ``vae_training_tpu/models/networks.py:45-188``. Semantics kept
(see that module's docstring, ``:7-18``):

  - the encoder outputs the posterior mean only; the posterior
    log-variance is one learned global vector ``epsilon_p`` (ones init);
  - with ``tunable_decoder_var`` the decoder log-variance is
    ``epsilon * epsilon_const`` with ``epsilon`` a learned (1,) scalar
    (ones init);
  - decoder output noise ``z2 * exp(ε/2)`` is added in both training and
    sampling mode;
  - sampling mode sets mu = logvar_e = 0, so the latent is exactly z1;
  - for the sigmoid dataset the decoder is a sum of a sigmoid-headed stack
    and a plain one: ``decode(s) = SigDecoder(s) + Decoder(s)``, the
    ``SigDecoder`` with the decoder's features.

Parameter names and layouts are flax's: ``Encoder.FC0.kernel`` is (in, out)
and the forward computes ``x @ kernel + bias``, so no transpose stands
between the two packages. Dense kernels are initialised like flax's
``lecun_normal`` (a normal truncated at ±2σ of the underlying normal, scaled
to std sqrt(1/fan_in)), biases to zero — not torch's ``nn.Linear`` default.

``bf16_dots`` (``config.bf16_dots``, ``--precision bf16`` on the card) is
the JAX model's ``matmul_precision``: every Dense product then takes
bfloat16 operands and f32 sums in both directions (``ops/precision.py``),
the bias added after.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.precision import dot

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling
# "truncated_normal" correction constant)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(kernel: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` in place: a normal truncated at ±2σ of the
    underlying normal, scaled to std sqrt(1/fan_in)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out), ``bias`` (out,); with
    ``bf16_dots`` its product is the bf16 dot (``ops/precision.py``)."""

    def __init__(self, in_features: int, out_features: int, bf16_dots: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.bf16_dots = bf16_dots

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dot(x, self.kernel, self.bf16_dots) + self.bias


class FullyConnectedNetwork(nn.Module):
    """Dense stack with ReLU between layers and none after the last (a
    sigmoid after it with ``sigmoid_head``). ``features`` includes the
    output dimension, so an empty hidden-layer string yields one Dense
    layer: a pure linear map."""

    def __init__(self, in_features: int, features: Sequence[int],
                 sigmoid_head: bool = False, bf16_dots: bool = False):
        super().__init__()
        widths = (in_features,) + tuple(features)
        for i in range(len(features)):
            self.add_module(f"FC{i}", Dense(widths[i], widths[i + 1], bf16_dots))
        self.n_layers = len(features)
        self.sigmoid_head = sigmoid_head
        self.bf16_dots = bf16_dots

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"FC{i}")(x)
            if i + 1 < self.n_layers:
                x = torch.relu(x)
        return torch.sigmoid(x) if self.sigmoid_head else x


class LatentVAE(nn.Module):
    """The reference's latent and noise semantics, shared by the MLP VAE and
    the conv VAE (``models/conv.py``): a global posterior log-variance
    ``epsilon_p``, the optional learned scale ``epsilon`` of the decoder
    log-variance, and decoder output noise in both modes. A subclass makes
    ``Encoder`` (flat or NHWC batch → posterior mean) and ``decode``
    (latents → flat batch), then calls ``_add_variances``."""

    dual_sigmoid_decoder = False
    bf16_dots = False  # the dot mode its layers were built with

    def _add_variances(self, latent_dim: int, epsilon: float,
                       tunable_decoder_var: bool) -> None:
        self.latent_dim = latent_dim
        self.epsilon_const = float(epsilon)  # the CLI ε
        self.tunable_decoder_var = tunable_decoder_var
        self.epsilon_p = nn.Parameter(torch.ones(latent_dim))
        if tunable_decoder_var:
            self.epsilon = nn.Parameter(torch.ones(1))  # learned scale of ε

    def init_parameters(self, seed: int) -> None:
        """Deterministic flax-style init from ``seed`` (drawn on the CPU, so
        a seed gives the same weights on every device): every layer's
        ``reset_parameters`` in module order, ones for the variances."""
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)
        with torch.no_grad():
            self.epsilon_p.fill_(1.0)
            if self.tunable_decoder_var:
                self.epsilon.fill_(1.0)

    def effective_epsilon(self) -> torch.Tensor:
        """Decoder log-variance: learned scalar × constant, or the constant."""
        if self.tunable_decoder_var:
            return self.epsilon * self.epsilon_const
        # torch.full, not torch.tensor: a host-to-device copy breaks a CUDA
        # graph's capture (train/step.py)
        return torch.full((), self.epsilon_const, dtype=torch.float32,
                          device=self.epsilon_p.device)

    def forward(self, x, z1, z2, sample_epsilon=None):
        """Training-mode forward: (x_hat, mu, logvar_e, epsilon). With
        ``sample_epsilon`` given, ancestral sampling instead (flax's
        ``method=generate``), so that both modes run through
        ``torch.func.functional_call`` with a state's parameters."""
        if sample_epsilon is not None:
            return self.generate(z1, z2, sample_epsilon)
        mu = self.Encoder(x)
        logvar_e = self.epsilon_p
        epsilon = self.effective_epsilon()
        samples = mu + torch.exp(logvar_e / 2.0) * z1
        x_hat = self.decode(samples) + z2 * torch.exp(epsilon / 2.0)
        return x_hat, mu, logvar_e, epsilon

    def generate(self, z1, z2, epsilon):
        """Ancestral sampling with the caller's decoder log-variance."""
        return self.decode(z1) + z2 * torch.exp(epsilon / 2.0)


class VAE(LatentVAE):
    """VAE with a global posterior log-variance and, for the sigmoid
    dataset, the dual decoder; module names mirror the reference tree
    (``Encoder``/``Decoder``/``SigDecoder`` with ``FC{i}``, ``epsilon_p``,
    ``epsilon``)."""

    def __init__(self, *, data_dim: int, encoder_features: Tuple[int, ...],
                 decoder_features: Tuple[int, ...], latent_dim: int,
                 epsilon: float = 0.0, tunable_decoder_var: bool = False,
                 dual_sigmoid_decoder: bool = False, bf16_dots: bool = False):
        super().__init__()
        self.data_dim = data_dim
        self.encoder_features = tuple(encoder_features)
        self.decoder_features = tuple(decoder_features)
        self.dual_sigmoid_decoder = dual_sigmoid_decoder
        self.bf16_dots = bf16_dots
        self.Encoder = FullyConnectedNetwork(data_dim, self.encoder_features,
                                             bf16_dots=bf16_dots)
        self.Decoder = FullyConnectedNetwork(latent_dim, self.decoder_features,
                                             bf16_dots=bf16_dots)
        if dual_sigmoid_decoder:
            self.SigDecoder = FullyConnectedNetwork(
                latent_dim, self.decoder_features, sigmoid_head=True, bf16_dots=bf16_dots)
        self._add_variances(latent_dim, epsilon, tunable_decoder_var)

    def decode(self, samples: torch.Tensor) -> torch.Tensor:
        x_hat = self.Decoder(samples)
        if self.dual_sigmoid_decoder:
            x_hat = self.SigDecoder(samples) + x_hat
        return x_hat


def parse_layer_sizes(spec: str) -> Tuple[int, ...]:
    """'512|512' → (512, 512); '' → () (pure linear model)."""
    if spec == "":
        return ()
    return tuple(int(s) for s in spec.split("|"))


def build_vae(*, data_dim: int, latent_dim: int, encoder_layer_sizes: str = "",
              decoder_layer_sizes: str = "", epsilon: float = 0.0,
              tunable_decoder_var: bool = False,
              dataset_name: Optional[str] = None, bf16_dots: bool = False) -> VAE:
    """Construct a VAE from the reference's CLI-level hyperparameters; the
    sigmoid dataset gets the dual decoder. ``bf16_dots`` is the resolved
    ``--precision`` (``config.bf16_dots``), the JAX ``build_vae``'s
    ``precision``."""
    enc = parse_layer_sizes(encoder_layer_sizes) + (latent_dim,)
    dec = parse_layer_sizes(decoder_layer_sizes) + (data_dim,)
    return VAE(data_dim=data_dim, encoder_features=enc, decoder_features=dec,
               latent_dim=latent_dim, epsilon=epsilon,
               tunable_decoder_var=tunable_decoder_var,
               dual_sigmoid_decoder=dataset_name == "sigmoid", bf16_dots=bf16_dots)
