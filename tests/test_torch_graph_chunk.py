"""The torch path's CUDA-graph chunk (``train/step.py`` ``GraphChunk``) and
the counter-as-tensor forms it rests on, on the CPU:

  - ``rng.words``/``rng.normals`` at a device int64 step equal the int
    form bitwise, past 2**32 too;
  - every dataset's ``sample`` at a tensor counter equals the int counter
    bitwise;
  - ``adam_update_`` with a tensor count equals the int count bitwise, f32
    and bf16 moments;
  - the graph's step (``counter_step_``) run eagerly for 20 steps equals
    ``train_chunk`` bitwise (losses, parameters, moments), linear and
    sphere with 8|8 stacks;
  - the dispatch choice (``torch_path_form``) as a pure function, and the
    ``[kernels]`` line that names it;
  - a ``cuda`` test holds the graph against the eager chunk on the card
    (skips here).

The file imports no JAX, so on the card it runs with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_chunk.py``.
"""

import contextlib
import io
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch._scripts.run import cli  # noqa: E402
from vae_training_tpu_torch.data import (  # noqa: E402
    GaussianDataset,
    LinearGaussianDataset,
    SigmoidDataset,
    SphereDataset,
)
from vae_training_tpu_torch.kernels.dispatch import torch_path_form  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.ops import rng  # noqa: E402
from vae_training_tpu_torch.train import TrainState, adam_update_  # noqa: E402
from vae_training_tpu_torch.train import step as torch_step  # noqa: E402

STEPS = [0, 1, 2**32 - 1, 2**32, 2**32 + 5]
SEED = rng.derive_seed(2, rng.SEED_TRAIN_DATA)


def _i64(v, device="cpu"):
    return torch.tensor(v, dtype=torch.int64, device=device)


@pytest.mark.parametrize("step", STEPS)
def test_tensor_counter_words_equal_the_int_form(step):
    for stream in (rng.STREAM_MANIFOLD, rng.STREAM_OBS):
        assert torch.equal(rng.words(SEED, _i64(step), 7, stream, 3),
                           rng.words(SEED, step, 7, stream, 3))
        assert torch.equal(rng.normals(SEED, _i64(step), 5, stream, 9),
                           rng.normals(SEED, step, 5, stream, 9))
    # the counter word is the step's low 32 bits
    assert torch.equal(rng.words(SEED, _i64(step), 2, 0, 1), rng.words(SEED, step % 2**32, 2, 0, 1))


@pytest.mark.parametrize("name", ["gaussian", "linear_gaussian", "sigmoid", "sphere"])
def test_dataset_sample_at_a_tensor_counter(name):
    ds = {"gaussian": GaussianDataset(3, 4, noise_level=0.1),
          "linear_gaussian": LinearGaussianDataset.create(2, 3, 3, 4, var_added=0.25),
          "sigmoid": SigmoidDataset.create(69, 3, 3),
          "sphere": SphereDataset(3, 3)}[name]
    for step in (3, 2**32 + 5):
        assert torch.equal(ds.sample(SEED, _i64(step), 50), ds.sample(SEED, step, 50))


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_adam_update_with_a_tensor_count(moments):
    rs = np.random.RandomState(3)
    for count in (1, 2, 17, 12001, 2**20 + 3):
        p, g = (torch.tensor(rs.randn(6, 5).astype(np.float32)) for _ in range(2))
        m = torch.tensor(rs.randn(6, 5).astype(np.float32) * 0.1).to(moments)
        v = torch.tensor(rs.rand(6, 5).astype(np.float32) * 0.01).to(moments)
        a = [t.clone() for t in (p, m, v)]
        b = [t.clone() for t in (p, m, v)]
        adam_update_(*a, g, count, 1e-3)
        adam_update_(*b, g, _i64(count), 1e-3)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), count


def _model_and_data(kind):
    if kind == "linear":
        ds = LinearGaussianDataset.create(2, 3, 3, 9)
        layers = ""
    else:
        ds = SphereDataset(3, 3)
        layers = "8|8"
    model = build_vae(data_dim=ds.dimension, latent_dim=6, encoder_layer_sizes=layers,
                      decoder_layer_sizes=layers, epsilon=-1.0, tunable_decoder_var=True)
    model.init_parameters(0)
    return model, ds


def _fresh(model, adam_dtype="f32"):
    return TrainState.create(dict(model.named_parameters()), SEED, 77, adam_dtype=adam_dtype)


@pytest.mark.parametrize("kind", ["linear", "sphere"])
def test_graph_step_body_eagerly_equals_train_chunk(kind):
    """The captured step, run op by op on the CPU with its device counters,
    against the op-by-op chunk: 20 steps from step 5, bitwise."""
    model, ds = _model_and_data(kind)
    a, b = _fresh(model), _fresh(model)
    a.step = b.step = 5
    a.count = b.count = 5
    a, losses_a = torch_step.train_chunk(model, ds, a, 20, batch_size=10, lr=1e-3)
    counters = (_i64(b.step), _i64(b.count + 1), _i64(0))
    losses_b = torch.full((32,), float("nan"))
    with torch_step._requiring_grad(b.params):
        for _ in range(20):
            torch_step.counter_step_(model, ds, b, counters, losses_b, batch_size=10, lr=1e-3)
    assert [int(c) for c in counters] == [25, 26, 20]
    assert torch.equal(losses_a, losses_b[:20])
    for tree in ("params", "m", "v"):
        ta, tb = getattr(a, tree), getattr(b, tree)
        for k in ta:
            assert torch.equal(ta[k], tb[k]), (tree, k)


def test_graph_chunk_with_external_noise_runs_op_by_op():
    model, ds = _model_and_data("linear")
    rs = np.random.RandomState(0)
    noise = tuple(torch.tensor(rs.randn(4, 10, d).astype(np.float32))
                  for d in (ds.dimension, 6, ds.dimension))
    a, b = _fresh(model), _fresh(model)
    calls = torch_step.GraphChunk.calls
    a, la = torch_step.GraphChunk(model, ds, batch_size=10, lr=1e-3)(a, 4, noise=noise)
    b, lb = torch_step.train_chunk(model, ds, b, 4, batch_size=10, lr=1e-3, noise=noise)
    assert torch_step.GraphChunk.calls == calls  # no graph chunk ran
    assert torch.equal(la, lb) and a.step == b.step == 4
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


def test_graph_chunk_refuses_a_cpu_state():
    model, ds = _model_and_data("linear")
    with pytest.raises(ValueError, match="needs a state on a CUDA device"):
        torch_step.GraphChunk(model, ds, batch_size=10, lr=1e-3)(_fresh(model), 3)


@pytest.mark.parametrize("cfg,noise,graph,words", [
    (dict(device="cuda"), False, True, "one CUDA graph replay a step"),
    (dict(device="cuda"), True, False, "eager (an external noise hook)"),
    (dict(device="cpu"), False, False, "eager (the CPU has no CUDA graphs)"),
    (dict(device="cuda", nojit=True), False, False, "eager (-nojit"),
    (dict(device="cuda", debug_nans=True), False, False, "eager (--debug_nans"),
    (dict(device="cpu", debug_nans=True), False, False, "eager (the CPU"),
])
def test_torch_path_form(cfg, noise, graph, words):
    got_graph, got_words = torch_path_form(
        SimpleNamespace(**{"nojit": False, "debug_nans": False, **cfg}), noise=noise)
    assert got_graph is graph and got_words.startswith(words)


ROW1 = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
        "-ow", "--latent_dim", "6", "--padding_dim", "3", "-dd", "3", "--epsilon", "-1",
        "-tdv", "--device", "cpu", "--kernels", "torch", "--num_batches", "3",
        "--n_print", "2", "--n_plot", "2"]


@pytest.mark.parametrize("extra,line", [
    ([], "[kernels] torch: plain PyTorch path (--kernels torch); "
         "eager (the CPU has no CUDA graphs)"),
    (["--seed_grid", "2,3"], "[kernels] torch: plain PyTorch path, row by row for 2 rows "
                             "(--kernels torch); eager (the CPU has no CUDA graphs)"),
])
def test_kernels_line_names_the_form(tmp_path, extra, line):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert cli(["f", *ROW1, "--data_dir", str(tmp_path), *extra]) == 0
    assert line in out.getvalue()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_adam_update_with_a_tensor_count_on_the_card(cuda_device, moments):
    """On a CUDA tensor ATen divides by a Python double as a product with
    its reciprocal rounded to float32: the tensor form must match that."""
    rs = np.random.RandomState(4)
    for count in list(range(1, 300)) + [12001, 2**20 + 3]:
        p, g = (torch.tensor(rs.randn(64).astype(np.float32), device=cuda_device)
                for _ in range(2))
        m = torch.tensor(rs.randn(64).astype(np.float32) * 0.1, device=cuda_device).to(moments)
        v = torch.tensor(rs.rand(64).astype(np.float32) * 0.01, device=cuda_device).to(moments)
        a = [t.clone() for t in (p, m, v)]
        b = [t.clone() for t in (p, m, v)]
        adam_update_(*a, g, count, 1e-3)
        adam_update_(*b, g, _i64(count, cuda_device), 1e-3)
        for x, y in zip(a, b):
            assert torch.equal(x, y), count


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "sphere"])
def test_graph_chunk_matches_eager_on_the_card(cuda_device, kind):
    """Chunks of 7, 1 and 12 steps (12 recaptures a longer loss buffer)
    as graph replays against the op-by-op chunk from the same state:
    losses, parameters and moments bitwise; the state's step and count."""
    model, ds = _model_and_data(kind)
    ds = (LinearGaussianDataset(ds.A.to(cuda_device), 3, 3, 9) if kind == "linear"
          else SphereDataset(3, 3, device=cuda_device))
    model.to(cuda_device)
    a, b = _fresh(model).to(cuda_device), _fresh(model).to(cuda_device)
    graph = torch_step.GraphChunk(model, ds, batch_size=10, lr=1e-3)
    for n in (7, 1, 12):
        a, la = torch_step.train_chunk(model, ds, a, n, batch_size=10, lr=1e-3)
        b, lb = graph(b, n)
        assert torch.equal(la, lb) and (a.step, a.count) == (b.step, b.count)
        for tree in ("params", "m", "v"):
            for k, t in getattr(a, tree).items():
                assert torch.equal(t, getattr(b, tree)[k]), (n, tree, k)
