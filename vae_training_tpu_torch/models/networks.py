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
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling
# "truncated_normal" correction constant)
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out), ``bias`` (out,)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.kernel.shape[0]) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class FullyConnectedNetwork(nn.Module):
    """Dense stack with ReLU between layers and none after the last (a
    sigmoid after it with ``sigmoid_head``). ``features`` includes the
    output dimension, so an empty hidden-layer string yields one Dense
    layer: a pure linear map."""

    def __init__(self, in_features: int, features: Sequence[int],
                 sigmoid_head: bool = False):
        super().__init__()
        widths = (in_features,) + tuple(features)
        for i in range(len(features)):
            self.add_module(f"FC{i}", Dense(widths[i], widths[i + 1]))
        self.n_layers = len(features)
        self.sigmoid_head = sigmoid_head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"FC{i}")(x)
            if i + 1 < self.n_layers:
                x = torch.relu(x)
        return torch.sigmoid(x) if self.sigmoid_head else x


class VAE(nn.Module):
    """VAE with a global posterior log-variance and, for the sigmoid
    dataset, the dual decoder; module names mirror the reference tree
    (``Encoder``/``Decoder``/``SigDecoder`` with ``FC{i}``, ``epsilon_p``,
    ``epsilon``)."""

    def __init__(self, *, data_dim: int, encoder_features: Tuple[int, ...],
                 decoder_features: Tuple[int, ...], latent_dim: int,
                 epsilon: float = 0.0, tunable_decoder_var: bool = False,
                 dual_sigmoid_decoder: bool = False):
        super().__init__()
        self.data_dim = data_dim
        self.encoder_features = tuple(encoder_features)
        self.decoder_features = tuple(decoder_features)
        self.latent_dim = latent_dim
        self.epsilon_const = float(epsilon)  # the CLI ε
        self.tunable_decoder_var = tunable_decoder_var
        self.dual_sigmoid_decoder = dual_sigmoid_decoder
        self.Encoder = FullyConnectedNetwork(data_dim, self.encoder_features)
        self.Decoder = FullyConnectedNetwork(latent_dim, self.decoder_features)
        if dual_sigmoid_decoder:
            self.SigDecoder = FullyConnectedNetwork(
                latent_dim, self.decoder_features, sigmoid_head=True)
        self.epsilon_p = nn.Parameter(torch.ones(latent_dim))
        if tunable_decoder_var:
            self.epsilon = nn.Parameter(torch.ones(1))  # learned scale of ε

    def init_parameters(self, seed: int) -> None:
        """Deterministic flax-style init from ``seed`` (drawn on the CPU, so
        a seed gives the same weights on every device)."""
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.reset_parameters(gen)
        with torch.no_grad():
            self.epsilon_p.fill_(1.0)
            if self.tunable_decoder_var:
                self.epsilon.fill_(1.0)

    def decode(self, samples: torch.Tensor) -> torch.Tensor:
        x_hat = self.Decoder(samples)
        if self.dual_sigmoid_decoder:
            x_hat = self.SigDecoder(samples) + x_hat
        return x_hat

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


def parse_layer_sizes(spec: str) -> Tuple[int, ...]:
    """'512|512' → (512, 512); '' → () (pure linear model)."""
    if spec == "":
        return ()
    return tuple(int(s) for s in spec.split("|"))


def build_vae(*, data_dim: int, latent_dim: int, encoder_layer_sizes: str = "",
              decoder_layer_sizes: str = "", epsilon: float = 0.0,
              tunable_decoder_var: bool = False,
              dataset_name: Optional[str] = None) -> VAE:
    """Construct a VAE from the reference's CLI-level hyperparameters; the
    sigmoid dataset gets the dual decoder."""
    enc = parse_layer_sizes(encoder_layer_sizes) + (latent_dim,)
    dec = parse_layer_sizes(decoder_layer_sizes) + (data_dim,)
    return VAE(data_dim=data_dim, encoder_features=enc, decoder_features=dec,
               latent_dim=latent_dim, epsilon=epsilon,
               tunable_decoder_var=tunable_decoder_var,
               dual_sigmoid_decoder=dataset_name == "sigmoid")
