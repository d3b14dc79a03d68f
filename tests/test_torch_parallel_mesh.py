"""The port's mesh resolution and tensor-parallel plan against the JAX
package's, on the CPU (no process group: the port's ``make_mesh`` takes a
device count, the JAX one the first n of the 8 host devices).

  - ``parse_mesh_spec`` and ``make_mesh`` over a table of specs × device
    counts (1, 4, 6, 8) × ``allow_uneven``: the same axes, sizes, order and
    device (rank) layout, or the same exception type and text, and the same
    ``[mesh]`` notice on stderr;
  - the tp plan (``parallel/gspmd.py param_sharding_tree``) against JAX's
    ``param_sharding_tree`` specs, leaf by leaf, for a 16|16 MLP and the
    200|200|200 sphere net (abstract shapes), a linear model and the
    sigmoid dual decoder, at tp = 2, 3, 4 and 8: the same specs, the same
    ``[tp]`` stderr notes, the same ZERO-sharded error, and
    ``--tp_allow_replicated`` lifting it;
  - the mesh's rank arithmetic: coordinates and the data index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

torch = pytest.importorskip("torch")

from vae_training_tpu.models import build_vae as jax_build_vae  # noqa: E402
from vae_training_tpu.parallel import gspmd as jax_gspmd  # noqa: E402
from vae_training_tpu.parallel import mesh as jax_mesh  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.parallel import gspmd, mesh  # noqa: E402

SPECS = ["dp=8", "dp=4,tp=2", "dp_dcn=2,dp=4", "dp=4,dp_dcn=2", "dp=-1", "dp=-1,tp=2",
         "tp=2", "tp=-1", "dp_dcn=2,dp=-1", "dp=-1,tp=-1", "dp=3", "dp=-1,tp=4",
         "dp_dcn=2,dp=2,tp=2", "dp=1", "", "pp=2", "dp", "dp=0", "dp=-2", "dp=2,dp=2",
         " dp = 2 , tp=1 ", "tp=3,dp=-1"]


def _outcome(fn, capsys):
    try:
        value = fn()
    except Exception as e:  # noqa: BLE001 — the type and text are compared
        value = (type(e).__name__, str(e))
    return value, capsys.readouterr().err


@pytest.mark.parametrize("n", [1, 4, 6, 8])
@pytest.mark.parametrize("spec", SPECS)
def test_make_mesh_against_jax(spec, n, capsys):
    devices = jax.devices()[:n]
    assert len(devices) == n
    assert _outcome(lambda: mesh.parse_mesh_spec(spec), capsys) == \
        _outcome(lambda: jax_mesh.parse_mesh_spec(spec), capsys)
    for uneven in (False, True):
        want, want_err = _outcome(lambda: jax_mesh.make_mesh(spec, devices=devices,
                                                             allow_uneven=uneven), capsys)
        got, got_err = _outcome(lambda: mesh.make_mesh(spec, devices=n, allow_uneven=uneven),
                                capsys)
        assert got_err == want_err
        if isinstance(want, tuple):
            assert got == want
            continue
        assert isinstance(got, mesh.Mesh), got
        assert got.axis_names == want.axis_names
        assert got.shape == dict(want.shape)
        ids = np.vectorize(lambda d: devices.index(d))(want.devices)
        np.testing.assert_array_equal(got.ranks, ids)


def test_mesh_rank_arithmetic():
    m = mesh.make_mesh("dp_dcn=2,dp=2,tp=2", devices=8)
    assert m.coords(5) == {"dp_dcn": 1, "dp": 0, "tp": 1}
    # the linearised (dp_dcn, dp) index: the same batch shard as dp=4's rank
    flat = mesh.make_mesh("dp=4,tp=2", devices=8)
    assert [m.data_index(r) for r in range(8)] == [flat.data_index(r) for r in range(8)]
    assert [m.data_index(r) for r in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    uneven = mesh.make_mesh("dp=-1,tp=2", devices=7, allow_uneven=True)
    assert uneven.contains(5) and not uneven.contains(6) and uneven.coords(6) is None
    assert uneven.groups("cpu") == {}  # no process group: one rank, no group


MODELS = {
    "mlp16": dict(data_dim=5, latent_dim=4, encoder_layer_sizes="16|16",
                  decoder_layer_sizes="16|16"),
    "sphere": dict(data_dim=6, latent_dim=6, encoder_layer_sizes="200|200|200",
                   decoder_layer_sizes="200|200|200"),
    "linear": dict(data_dim=12, latent_dim=20),
    "sigmoid": dict(data_dim=7, latent_dim=6, encoder_layer_sizes="16",
                    decoder_layer_sizes="16", dataset_name="sigmoid"),
}


def _jax_shapes(kw):
    jm = jax_build_vae(**kw, epsilon=-3.0, tunable_decoder_var=True)
    d, latent = kw["data_dim"], kw["latent_dim"]
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, d)),
                                          jnp.zeros((1, latent)), jnp.zeros((1, d))))["params"]


@pytest.mark.parametrize("tp", [2, 3, 4, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_tp_plan_against_jax(model, tp, capsys):
    kw = MODELS[model]
    shapes = {k: tuple(p.shape) for k, p in build_vae(
        **kw, epsilon=-3.0, tunable_decoder_var=True).named_parameters()}
    jshapes = _jax_shapes(kw)
    flat = {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes)}
    assert flat == shapes
    jmesh = JaxMesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))
    for allow in (False, True):
        want, want_err = _outcome(lambda: jax_gspmd.param_sharding_tree(
            jshapes, jmesh, allow_replicated=allow), capsys)
        got, got_err = _outcome(lambda: gspmd.param_sharding_tree(
            shapes, tp, allow_replicated=allow), capsys)
        assert got_err == want_err
        if isinstance(want, tuple):
            assert got == want
            continue
        want = {".".join(str(k.key) for k in path): tuple(s.spec)
                for path, s in jax.tree_util.tree_leaves_with_path(want)}
        assert got == want
    # the moments' plan is quiet, and never raises (state_sharding_tree)
    gspmd.param_sharding_tree(shapes, tp, allow_replicated=True, quiet=True)
    assert capsys.readouterr().err == ""


def test_tp_refusal_is_the_zero_sharded_error(capsys):
    shapes = {k: tuple(p.shape) for k, p in build_vae(
        **MODELS["sphere"], epsilon=-3.0).named_parameters()}
    with pytest.raises(ValueError, match=r"tensor parallelism tp=3 shards ZERO parameters"):
        gspmd.param_sharding_tree(shapes, 3)
    assert "--tp_allow_replicated" in str(pytest.raises(
        ValueError, gspmd.param_sharding_tree, shapes, 3).value)
    specs = gspmd.param_sharding_tree(shapes, 3, allow_replicated=True)
    assert not any("tp" in s for s in specs.values())
    assert "[tp] parameter ['Encoder']['FC0']['kernel'] (shape (6, 200)) is not " \
           "divisible by tp=3; training it REPLICATED" in capsys.readouterr().err
