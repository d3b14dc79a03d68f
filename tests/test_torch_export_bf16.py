"""A JAX ``--adam_dtype bf16`` run's model.pkl loads into the port without
``ml_dtypes``.

The JAX package pickles such a run's weight-matrix moments as
``ml_dtypes.bfloat16`` arrays, whose dtype unpickles through
``find_class("ml_dtypes", "bfloat16")``. The port depends on no such
package: ``load_model_pkl`` reads those arrays as their uint16 bit patterns
and ``state_from_flax`` makes them bfloat16 tensors of the same bits. The
file is written here, with ``ml_dtypes`` present; it is read in a
subprocess in which ``import ml_dtypes`` fails, through ``load_model_pkl``
and through a run's ``--state_dict``. The bits must equal the JAX moments,
and every float32 leaf must come through unchanged.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kernel_test_helpers import run_xla_steps  # noqa: E402
from vae_training_tpu.data import LinearGaussianDataset as JaxLinear  # noqa: E402
from vae_training_tpu.kernels.linear_vae import _adam_state  # noqa: E402
from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.runio import export as jax_export  # noqa: E402
from vae_training_tpu.train import TrainState as JaxTrainState  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 32

# Runs with ml_dtypes blocked: a plain pickle.load must fail, then the
# port's loader and a bf16 run's --state_dict must not. Writes every leaf
# (bfloat16 ones as int16 bit patterns) to an npz.
LOADER = r"""
import pickle, sys
sys.modules["ml_dtypes"] = None
import numpy as np, torch
pkl, out, data_dir = sys.argv[1:4]
try:
    with open(pkl, "rb") as f:
        pickle.load(f)
    raise SystemExit("pickle.load read a bf16 model.pkl without ml_dtypes")
except ImportError:
    pass
from vae_training_tpu_torch.config import parse_arguments
from vae_training_tpu_torch.data import LinearGaussianDataset
from vae_training_tpu_torch.runio.export import load_model_pkl
from vae_training_tpu_torch.train.loop import Trainer
assert "jax" not in sys.modules
loaded = load_model_pkl(pkl)
cfg = parse_arguments(["s", "--dataset", "linear_gaussian", "--encoder_layer_sizes", "",
                       "--layer_sizes", "", "-ow", "--latent_dim", "20", "--padding_dim", "9",
                       "-dd", "3", "--epsilon", "-1", "-tdv", "--device", "cpu",
                       "--adam_dtype", "bf16", "--state_dict", pkl, "--data_dir", data_dir])
run = Trainer(cfg, LinearGaussianDataset.create(2, 3, 3, 9), data_dir).state
arrays = {}
for label, st in (("load", loaded), ("run", run)):
    for part in ("params", "m", "v"):
        for name, t in getattr(st, part).items():
            key = f"{label}/{part}/{name}"
            if t.dtype == torch.bfloat16:
                arrays[key + "/bf16"] = t.view(torch.int16).numpy()
            else:
                arrays[key] = t.numpy()
arrays["load/count"] = np.array(loaded.count)
arrays["run/count"] = np.array(run.count)
np.savez(out, **arrays)
"""


def _named(tree):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jax.device_get(tree))}


@pytest.fixture(scope="module")
def jax_bf16_pkl(tmp_path_factory):
    """A JAX bf16 run's model.pkl after 3 steps (non-zero moments), with
    the JAX params and moments it holds."""
    ds = JaxLinear.create(2, dimension=3, intrinsic_dimension=3, padding_dimension=9)
    model = jax_build_vae(data_dim=12, latent_dim=20, encoder_layer_sizes="",
                          decoder_layer_sizes="", epsilon=-1.0, tunable_decoder_var=True)
    tx = make_adam(1e-3, "bf16")
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 12)), jnp.zeros((1, 20)),
                        jnp.zeros((1, 12)))["params"]
    state = JaxTrainState.create(params=params, tx=tx, model_key=jax.random.PRNGKey(1),
                                 data_key=jax.random.PRNGKey(2))
    rs = np.random.RandomState(0)
    xs = np.zeros((3, BATCH, 12), np.float32)
    xs[:, :, :3] = rs.randn(3, BATCH, 3).astype(np.float32) @ np.asarray(ds.A).T
    z1s = rs.randn(3, BATCH, 20).astype(np.float32)
    z2s = rs.randn(3, BATCH, 12).astype(np.float32)
    params, opt, _ = run_xla_steps(model, tx, state, *map(jnp.asarray, (xs, z1s, z2s)))
    path = tmp_path_factory.mktemp("jax_bf16") / "model.pkl"
    jax_export.save_model_pkl(str(path), params, opt)
    adam = _adam_state(opt)
    return path, {"params": _named(params), "m": _named(adam.mu), "v": _named(adam.nu),
                  "count": int(adam.count)}


@pytest.fixture(scope="module")
def loaded_without_ml_dtypes(jax_bf16_pkl, tmp_path_factory):
    path, _ = jax_bf16_pkl
    work = tmp_path_factory.mktemp("load")
    out = work / "leaves.npz"
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", LOADER, str(path), str(out), str(work)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


def test_jax_bf16_model_pkl_holds_ml_dtypes_bfloat16(jax_bf16_pkl):
    _, ref = jax_bf16_pkl
    dtypes = {name: a.dtype.name for part in ("m", "v") for name, a in ref[part].items()}
    assert dtypes["Encoder.FC0.kernel"] == dtypes["Decoder.FC0.kernel"] == "bfloat16"
    assert dtypes["Encoder.FC0.bias"] == "float32"
    assert ref["count"] == 3


@pytest.mark.parametrize("via", ["load", "run"], ids=["load_model_pkl", "state_dict"])
def test_bf16_model_pkl_loads_bit_for_bit_without_ml_dtypes(jax_bf16_pkl,
                                                           loaded_without_ml_dtypes, via):
    _, ref = jax_bf16_pkl
    got = loaded_without_ml_dtypes
    assert int(got[f"{via}/count"]) == ref["count"]
    n_bf16 = 0
    for part in ("params", "m", "v"):
        for name, want in ref[part].items():
            if want.dtype.name == "bfloat16":
                n_bf16 += 1
                key = f"{via}/{part}/{name}/bf16"
                assert key in got, f"{key}: a bfloat16 leaf must load as bfloat16"
                np.testing.assert_array_equal(got[key], want.view(np.int16), err_msg=key)
            else:
                key = f"{via}/{part}/{name}"
                assert want.dtype == np.float32 and got[key].dtype == np.float32, key
                np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert n_bf16 == 4  # m and v of the encoder's and the decoder's kernel


def test_state_from_flax_refuses_unknown_dtypes():
    from vae_training_tpu_torch.runio.export import state_from_flax

    leaf = {"epsilon": np.zeros(1, np.float16)}
    with pytest.raises(TypeError, match="float16"):
        state_from_flax(leaf, leaf, leaf, 0)

