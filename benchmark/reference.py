"""The plain reference the benchmark holds the port's timed path to.

Plain PyTorch in float32 with TF32 off, its backward by autograd. It imports
nothing of the program: the noise streams (Philox4x32-10 keyed by a 64-bit
seed, counter (step, row, draw, stream)), the manifold samplers, the VAE's
forward and closed-form ELBO, Adam and the eval are written out here again
from the published semantics, so that a change to the program cannot move
the yardstick.

What a row is: its data dim ``dd``, padding ``pd``, latent dim ``ld``, its
dataset seed, the configuration's hidden widths and hyperparameters, and
the initial parameters the benchmark made (``make_init``). The reference
derives every stream seed, the linear manifold's matrix and the data itself
from those, as the program does.

``dot`` is where precision enters: ``None`` is a float32 product; a
rounding function rounds both operands going forward and the cotangent
going back, as a lower-precision matrix unit would (``fp8_round`` is the
control's).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
MASK32, MASK64 = 0xFFFFFFFF, (1 << 64) - 1

STREAM_MANIFOLD, STREAM_Z1, STREAM_Z2, STREAM_OBS = 0, 1, 2, 3
SEED_TRAIN_DATA, SEED_EVAL_DATA, SEED_TRAIN_Z, SEED_EVAL_Z = 1, 2, 3, 4

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LOG_2PI = math.log(2.0 * math.pi)
TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
EVAL_BATCH = 1000
FP8_MAX = 448.0

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


# --- noise -------------------------------------------------------------------

def _mulhilo(a: int, b: torch.Tensor):
    p_lo = (a & 0xFFFF) * b
    p_hi = (a >> 16) * b
    mid = p_hi + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _key(seed: int):
    seed &= MASK64
    return seed & MASK32, seed >> 32


def derive_seed(seed: int, purpose: int) -> int:
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    w = philox(t(0), t(0), t(0), t(purpose), *_key(seed))
    return int(w[0]) | (int(w[1]) << 32)


def normals(seed: int, step: int, rows: int, stream: int, dim: int, device) -> torch.Tensor:
    """(rows, dim) standard normals: Box-Muller over words (0, 1) and (2, 3)
    of the draw at counter (step, row, draw, stream)."""
    i64 = dict(dtype=torch.int64, device=device)
    n_draws = (dim + 3) // 4
    c0 = torch.full((), step & MASK32, **i64)
    c1 = torch.arange(rows, **i64).view(rows, 1)
    c2 = torch.arange(n_draws, **i64).view(1, n_draws)
    c3 = torch.full((), stream, **i64)
    w = torch.stack(philox(*torch.broadcast_tensors(c0, c1, c2, c3), *_key(seed)), -1)
    u = ((w >> 8).to(torch.float32) + 0.5) * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * torch.log(u[..., 0::2]))
    theta = 2.0 * math.pi * u[..., 1::2]
    out = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1).flatten(-2)
    return out.reshape(rows, 4 * n_draws)[:, :dim]


# --- precision ---------------------------------------------------------------

def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 (saturating at ±448), as float32."""
    return t.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)


class _RoundedDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        ctx.rnd = rnd
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        g = ctx.rnd(g)
        return g @ ctx.rnd(rb.T), ctx.rnd(ra.T) @ g, None


def dot(a: torch.Tensor, b: torch.Tensor, rnd: Rounding) -> torch.Tensor:
    return a @ b if rnd is None else _RoundedDot.apply(a, b, rnd)


# --- a row ---------------------------------------------------------------------

class Row:
    """One sweep row: its shape, its seeds and the configuration's
    hyperparameters."""

    def __init__(self, config: dict, dd: int, pd: int, ld: int, dataset_seed: int,
                 model_seed: int, device):
        self.dataset = config["dataset"]
        self.dd, self.pd, self.ld = dd, pd, ld
        self.D = dd + pd
        self.hidden_enc = _widths(config["encoder_layer_sizes"])
        self.hidden_dec = _widths(config["layer_sizes"])
        self.batch = config["batch_size"]
        self.lr = config["learning_rate"]
        self.eps_const = config["epsilon"]
        self.tdv = config["tunable_decoder_var"]
        self.intrinsic = config.get("dataset_intrinsic_dimension", 3)
        if config.get("dataset_noise", 0.0) != 0.0:
            raise ValueError("the reference draws no observation noise")
        self.device = torch.device(device)
        self.data_seed = derive_seed(dataset_seed, SEED_TRAIN_DATA)
        self.eval_data_seed = derive_seed(dataset_seed, SEED_EVAL_DATA)
        self.z_seed = derive_seed(model_seed, SEED_TRAIN_Z)
        self.eval_z_seed = derive_seed(model_seed, SEED_EVAL_Z)
        self.A = None
        if self.dataset == "linear_gaussian":
            # the manifold's matrix: numpy's default_rng of the dataset seed,
            # redrawn until full rank
            gen = np.random.default_rng(dataset_seed)
            while True:
                a = gen.standard_normal((dd, self.intrinsic))
                if int(np.linalg.matrix_rank(a)) == min(dd, self.intrinsic):
                    break
            self.A = torch.tensor(np.asarray(a, np.float32), device=self.device)
        elif self.dataset != "sphere":
            raise ValueError(f"the reference has no sampler for {self.dataset!r}")

    @property
    def enc_widths(self):
        return (self.D, *self.hidden_enc, self.ld)

    @property
    def dec_widths(self):
        return (self.ld, *self.hidden_dec, self.D)

    def shapes(self) -> Dict[str, tuple]:
        """Every parameter's name (the program's flax names) and shape."""
        out = {}
        for stack, w in (("Encoder", self.enc_widths), ("Decoder", self.dec_widths)):
            for i in range(len(w) - 1):
                out[f"{stack}.FC{i}.kernel"] = (w[i], w[i + 1])
                out[f"{stack}.FC{i}.bias"] = (w[i + 1],)
        out["epsilon_p"] = (self.ld,)
        if self.tdv:
            out["epsilon"] = (1,)
        return out

    def sample(self, seed: int, step: int, n: int, rnd: Rounding) -> torch.Tensor:
        if self.dataset == "sphere":
            g = normals(seed, step, n, STREAM_MANIFOLD, self.dd, self.device)
            x = g * torch.rsqrt(torch.clamp(torch.sum(g * g, 1, keepdim=True), min=1e-20))
        else:
            lat = normals(seed, step, n, STREAM_MANIFOLD, self.intrinsic, self.device)
            with torch.no_grad():
                x = dot(lat, self.A.T, rnd)
        return torch.cat([x, x.new_zeros(n, self.pd)], 1)

    def _mlp(self, P, stack: str, n_layers: int, h, rnd: Rounding):
        for i in range(n_layers):
            h = dot(h, P[f"{stack}.FC{i}.kernel"], rnd) + P[f"{stack}.FC{i}.bias"]
            if i + 1 < n_layers:
                h = torch.relu(h)
        return h

    def decode(self, P, s, rnd: Rounding):
        return self._mlp(P, "Decoder", len(self.dec_widths) - 1, s, rnd)

    def epsilon(self, P):
        if self.tdv:
            return P["epsilon"] * self.eps_const
        return torch.full((), self.eps_const, device=self.device)

    def terms(self, P, x, z1, z2, rnd: Rounding):
        """(loss, KL, reconstruction NLL) means of the training-mode forward."""
        mu = self._mlp(P, "Encoder", len(self.enc_widths) - 1, x, rnd)
        logvar_e, eps = P["epsilon_p"], self.epsilon(P)
        s = mu + torch.exp(logvar_e / 2.0) * z1
        x_hat = self.decode(P, s, rnd) + z2 * torch.exp(eps / 2.0)
        kl = -0.5 * torch.sum(1.0 + logvar_e - torch.exp(logvar_e) - mu * mu, -1)
        nll = torch.sum(0.5 * (x_hat - x) ** 2 / torch.exp(eps) + 0.5 * (LOG_2PI + eps), -1)
        return torch.mean(kl + nll), torch.mean(kl), torch.mean(nll)


def _widths(spec: str) -> tuple:
    return tuple(int(s) for s in spec.split("|")) if spec else ()


# --- training and the eval -----------------------------------------------------

def train(row: Row, init: Dict[str, torch.Tensor], n_steps: int, rnd: Rounding = None,
          half_batch: bool = False, frozen: bool = False, stale: bool = False) -> dict:
    """``n_steps`` steps of Adam from ``init`` on the row's own draws:
    {"loss": [n_steps floats], "g1": the first step's gradients, "delta":
    the parameters' change after ``n_steps``}. Faults, for the checks
    that ``correct`` can fail: ``half_batch`` takes the mean over the first
    half of each batch only; ``frozen`` returns the state unchanged (Adam's
    first moment stays 0, so the gradient read from it is 0); ``stale``
    gives the last step the draws of the one before (a launch whose later
    steps reuse its first step's data and noise)."""
    P = {k: t.detach().clone().float() for k, t in init.items()}
    m = {k: torch.zeros_like(t) for k, t in P.items()}
    v = {k: torch.zeros_like(t) for k, t in P.items()}
    n = row.batch // 2 if half_batch else row.batch
    losses, g1 = [], None
    for step in range(n_steps):
        drawn = step - 1 if stale and step == n_steps - 1 else step
        x = row.sample(row.data_seed, drawn, row.batch, rnd)[:n]
        z1 = normals(row.z_seed, drawn, row.batch, STREAM_Z1, row.ld, row.device)[:n]
        z2 = normals(row.z_seed, drawn, row.batch, STREAM_Z2, row.D, row.device)[:n]
        leaves = {k: t.requires_grad_(True) for k, t in P.items()}
        loss = row.terms(leaves, x, z1, z2, rnd)[0]
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = {k: g.detach().clone() * (0.0 if frozen else 1.0) for k, g in grads.items()}
        if frozen:
            P = {k: t.detach() for k, t in P.items()}
            continue
        t = step + 1
        with torch.no_grad():
            for k in P:
                P[k] = P[k].detach()
                g = grads[k]
                m[k] = ADAM_B1 * m[k] + (1.0 - ADAM_B1) * g
                v[k] = ADAM_B2 * v[k] + (1.0 - ADAM_B2) * g * g
                m_hat = m[k] / (1.0 - ADAM_B1 ** t)
                v_hat = v[k] / (1.0 - ADAM_B2 ** t)
                P[k] = P[k] - row.lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    delta = {k: (P[k] - init[k].float()).detach() for k in P}
    return {"loss": losses, "g1": g1, "delta": delta}


@torch.no_grad()
def evaluate(row: Row, params: Dict[str, torch.Tensor], counter: int, epsilon: float,
             rnd: Rounding = None, half_batch: bool = False) -> Dict[str, float]:
    """The stats one eval writes: the ELBO terms on a real batch of 1000 and
    the manifold's scores of a batch generated from the same prior draw,
    decoded with the decoder log-variance ``epsilon``."""
    n = EVAL_BATCH // 2 if half_batch else EVAL_BATCH
    real = row.sample(row.eval_data_seed, counter, EVAL_BATCH, rnd)[:n]
    z1 = normals(row.eval_z_seed, counter, EVAL_BATCH, STREAM_Z1, row.ld, row.device)[:n]
    z2 = normals(row.eval_z_seed, counter, EVAL_BATCH, STREAM_Z2, row.D, row.device)[:n]
    P = {k: t.float() for k, t in params.items()}
    fake = row.decode(P, z1, rnd) + z2 * math.exp(epsilon / 2.0)
    loss, kl, nll = row.terms(P, real, z1, z2, rnd)
    out = {"VAE Loss": float(loss), "KL divergence": float(kl), "mse": float(nll)}
    if row.dataset == "sphere":
        norm = torch.linalg.vector_norm(fake[:, :row.dd], dim=1)
        out["Sphere Error"] = float(torch.mean((norm - 1.0) ** 2))
        out["Padding Error"] = float(torch.mean(
            torch.linalg.vector_norm(fake[:, row.dd:], dim=1) ** 2))
    else:
        out["Squared Norm of padding dimensions"] = float(torch.mean(
            torch.sum(fake[:, row.dd:] ** 2, 1)))
    return out


# --- initial parameters --------------------------------------------------------

def make_init(rows: Sequence[Row], seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """Every row's initial parameters from ``seed``, drawn on ``device`` in
    one call: each weight matrix a normal clipped at ±2 and scaled to std
    sqrt(1/fan_in) (a truncated LeCun normal), biases 0, ``epsilon_p`` and
    ``epsilon`` 1. Rows get disjoint slices of the draw, so no two rows
    start alike."""
    shapes = [row.shapes() for row in rows]
    sizes = [int(np.prod(s)) for sh in shapes for k, s in sh.items() if k.endswith(".kernel")]
    gen = torch.Generator(device=device).manual_seed(int(seed) & MASK64)
    draw = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    out, off = [], 0
    for sh in shapes:
        params = {}
        for k, s in sh.items():
            if k.endswith(".kernel"):
                n = int(np.prod(s))
                params[k] = draw[off:off + n].view(s) * (math.sqrt(1.0 / s[0]) / TRUNC_STD)
                off += n
            elif k.endswith(".bias"):
                params[k] = torch.zeros(s, device=device)
            else:
                params[k] = torch.ones(s, device=device)
        out.append(params)
    return out
