"""Tensor parallelism over ranks, written out: dp × tp meshes.

Port of ``vae_training_tpu/parallel/gspmd.py`` (the file keeps its name so
that a reader finds the counterpart). The JAX package annotates shardings
and lets XLA's partitioner insert the collectives; torch has no
partitioner, so the Megatron rule of ``gspmd.py:28-49`` is explicit code
here:

  - ``FC{even}`` is column-parallel: its kernel shards its output dim and
    its bias shards with it; its input must be whole;
  - ``FC{odd}`` is row-parallel: its kernel shards its input dim, its bias
    is replicated, and its output is all-reduced before the bias;
  - a leaf whose dim ``tp`` does not divide trains replicated
    (``shardable``, with the JAX package's stderr note and its error when
    no parameter is left sharded, which ``--tp_allow_replicated`` lifts);
  - an activation whose next consumer needs it whole is all-gathered.

The collectives are autograd functions (Megatron's f and g, and the
gather/scatter pair), so the backward runs the matching collectives. The
batch shards over (``dp_dcn``, ``dp``) together, rows ``[r·lb,
(r+1)·lb)`` of the one-device draw for data index r (``parallel/dp.py``),
and the gradients are averaged over those axes; so tp and dp×tp equal the
single-device step up to reduction order. Each rank holds its shard of
every parameter and of its Adam moments (``place_state``);
``full_state`` all-gathers them, for evals, figures, ``model.pkl`` and
checkpoints in the reference layout. Tensor parallelism runs op by op on
every device: its collectives sit inside the forward and the backward.
Under bf16 dots (``--precision bf16`` on the card) each rank's local
product is the bf16 dot (``ops/precision.py``) and the collectives sum its
f32 results, as XLA's partitioned dot rounds its local operands.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..ops import elbo_terms
from ..ops.precision import dot
from ..train.state import TrainState
from .dp import DataParallel


def keystr(name: str) -> str:
    """A port parameter name as ``jax.tree_util.keystr`` prints its path:
    ``Encoder.FC0.kernel`` → ``['Encoder']['FC0']['kernel']``."""
    return "".join(f"[{k!r}]" for k in name.split("."))


def param_spec(name: str) -> tuple:
    """The requested PartitionSpec of one parameter, as a tuple, by its
    name: kernels alternate column-parallel ``(None, "tp")`` and
    row-parallel ``("tp", None)`` by layer index, a column-parallel bias
    shards with its output ``("tp",)``, everything else is ``()``."""
    keys = name.split(".")
    layer = next((k for k in keys if k.startswith("FC")), None)
    if layer is None:
        return ()
    col_parallel = int(layer[2:]) % 2 == 0
    kind = keys[-1]
    if kind == "kernel":
        return (None, "tp") if col_parallel else ("tp", None)
    if kind == "bias":
        return ("tp",) if col_parallel else ()
    return ()


def shardable(spec: tuple, shape: tuple, tp: int, name: str = "", dropped=None,
              quiet: bool = False) -> tuple:
    """Resolve a requested spec against the leaf's shape: a ``tp`` that
    does not divide its dim is dropped, recorded in ``dropped`` and
    announced on stderr (``quiet`` for the Adam moments)."""
    out = []
    for i, axis in enumerate(spec):
        if axis == "tp" and (i >= len(shape) or shape[i] % tp != 0):
            label = keystr(name) if name else "<param>"
            if dropped is not None:
                dropped.append((label, tuple(shape)))
            if not quiet:
                print(f"[tp] parameter {label} (shape {tuple(shape)}) is not "
                      f"divisible by tp={tp}; training it REPLICATED",
                      file=sys.stderr, flush=True)
            out.append(None)
        else:
            out.append(axis)
    while len(out) > len(shape):
        out.pop()
    return tuple(out)


def param_sharding_tree(shapes: Dict[str, tuple], tp: int, allow_replicated: bool = False,
                        quiet: bool = False) -> Dict[str, tuple]:
    """{name: resolved spec} for parameters of the given shapes under the
    Megatron rule, visited in the JAX tree's (sorted) order. Raises when
    tp > 1 leaves zero parameters sharded, unless ``allow_replicated``."""
    dropped: list = []
    specs, sharded = {}, 0
    for name in sorted(shapes, key=lambda n: n.split(".")):
        spec = param_spec(name) if tp > 1 else ()
        spec = shardable(spec, tuple(shapes[name]), tp, name=name, dropped=dropped,
                         quiet=quiet)
        sharded += "tp" in spec
        specs[name] = spec
    if tp > 1 and dropped and sharded == 0 and not allow_replicated:
        names = ", ".join(f"{n}{s}" for n, s in dropped)
        raise ValueError(
            f"tensor parallelism tp={tp} shards ZERO parameters: every "
            f"requested sharding was dropped for non-divisibility "
            f"({names}). The model would train fully replicated at tp=1 "
            f"speed — pick a tp that divides the layer widths, or pass "
            f"--tp_allow_replicated to accept it."
        )
    return specs


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: all-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather along the last dim forward; the rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group, rank, tp):
        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(tp)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.rank * w:(ctx.rank + 1) * w].contiguous(), None, None, None


class _ScatterToTP(torch.autograd.Function):
    """The rank's slice of the last dim forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, group, rank, tp):
        ctx.group, ctx.tp = group, tp
        w = x.shape[-1] // tp
        return x[..., rank * w:(rank + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g) for _ in range(ctx.tp)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=-1), None, None, None


@dataclass
class TensorParallel(DataParallel):
    """``DataParallel`` whose loss runs the model's Dense stacks sharded
    over the ``tp`` group: ``specs`` ({name: resolved spec}), this rank's
    ``tp_rank`` of ``tp`` and the ``tp_group``."""

    specs: Dict[str, tuple] = field(default_factory=dict)
    tp: int = 1
    tp_rank: int = 0
    tp_group: Optional[object] = None

    def _stack(self, net: str, module, x, params):
        group, rank, tp = self.tp_group, self.tp_rank, self.tp
        sharded = False  # is x split over tp along its features?
        bf16 = module.bf16_dots  # each local product a bf16 dot; the collectives outside it
        for i in range(module.n_layers):
            kernel, bias = params[f"{net}.FC{i}.kernel"], params[f"{net}.FC{i}.bias"]
            spec = self.specs[f"{net}.FC{i}.kernel"]
            if spec == ("tp", None):  # row-parallel
                if not sharded:
                    x = _ScatterToTP.apply(x, group, rank, tp)
                x = _ReduceFromTP.apply(dot(x, kernel, bf16), group) + bias
                sharded = False
            else:
                if sharded:
                    x = _GatherFromTP.apply(x, group, rank, tp)
                if spec == (None, "tp"):  # column-parallel
                    x = dot(_CopyToTP.apply(x, group), kernel, bf16) + bias
                    sharded = True
                else:
                    x = dot(x, kernel, bf16) + bias
                    sharded = False
            if i + 1 < module.n_layers:
                x = torch.relu(x)
        if sharded:
            x = _GatherFromTP.apply(x, group, rank, tp)
        return torch.sigmoid(x) if module.sigmoid_head else x

    def loss(self, model, params, x, z1, z2) -> torch.Tensor:
        """The VAE's ELBO loss (``models/networks.py`` ``LatentVAE.forward``)
        with every Dense stack sharded."""
        mu = self._stack("Encoder", model.Encoder, x, params)
        logvar_e = params["epsilon_p"]
        epsilon = (params["epsilon"] * model.epsilon_const if model.tunable_decoder_var
                   else torch.full((), model.epsilon_const, dtype=torch.float32,
                                   device=logvar_e.device))
        samples = mu + torch.exp(logvar_e / 2.0) * z1
        x_hat = self._stack("Decoder", model.Decoder, samples, params)
        if model.dual_sigmoid_decoder:
            x_hat = self._stack("SigDecoder", model.SigDecoder, samples, params) + x_hat
        x_hat = x_hat + z2 * torch.exp(epsilon / 2.0)
        return elbo_terms(x, x_hat, mu, logvar_e, epsilon)[0]

    def _dim(self, name: str) -> Optional[int]:
        spec = self.specs[name]
        return spec.index("tp") if "tp" in spec else None

    def place_state(self, state: TrainState) -> TrainState:
        """This rank's shard of every parameter and Adam moment (the
        moments follow their parameter's spec); the rest as it is."""
        def shard(tree):
            out = {}
            for k, t in tree.items():
                d = self._dim(k)
                if d is not None:
                    w = t.shape[d] // self.tp
                    t = t.narrow(d, self.tp_rank * w, w)
                out[k] = t.detach().clone()
            return out

        return replace(state, params=shard(state.params), m=shard(state.m), v=shard(state.v))

    def full_state(self, state: TrainState) -> TrainState:
        """The whole state, every sharded leaf all-gathered over tp (a
        collective: every rank of the tp group calls it)."""
        def gather(tree):
            out = {}
            for k, t in tree.items():
                d = self._dim(k)
                if d is not None:
                    parts = [torch.empty_like(t) for _ in range(self.tp)]
                    dist.all_gather(parts, t.contiguous(), group=self.tp_group)
                    t = torch.cat(parts, dim=d)
                out[k] = t
            return out

        return replace(state, params=gather(state.params), m=gather(state.m),
                       v=gather(state.v))


def tensor_parallel(mesh, model, batch_size: int, rank: int, device,
                    allow_replicated: bool = False) -> TensorParallel:
    """The ``TensorParallel`` of ``rank`` for ``model``: the JAX package's
    divisibility error, the resolved specs (stderr notes for the
    parameters, quiet for their moments, as ``state_sharding_tree``), and
    the mesh's device groups (a collective call)."""
    from .dp import data_parallel

    dp = mesh.shape.get("dp", 1) * mesh.shape.get("dp_dcn", 1)
    base = data_parallel(mesh, batch_size, rank, device, message=(
        f"--batch_size {batch_size} must be divisible by dp={dp}"))
    tp = mesh.shape["tp"]
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    specs = param_sharding_tree(shapes, tp, allow_replicated=allow_replicated)
    groups = mesh.groups(device)
    return TensorParallel(local_batch=base.local_batch, row0=base.row0, groups=base.groups,
                          specs=specs, tp=tp, tp_rank=mesh.coords(rank)["tp"],
                          tp_group=groups.get("tp"))
