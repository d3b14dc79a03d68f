"""The port's bench (``vae-bench-torch``) against the JAX bench on the CPU.

  - ``CONFIGS`` and ``CONFIG_SEEDS`` are the JAX bench's, and ``make_cfg``
    builds the same run config field by field (the port adds ``--device``);
  - ``mlp_step_flops``, ``conv_step_flops`` and ``workload_flops_per_step``
    count exactly what the JAX functions count, on the hand cases of
    ``tests/test_bench_flops.py`` and on trainers and grids of all six
    configs built by both benches (integers, compared exactly);
  - ``measure`` and ``measure_grid`` return positive rates at tiny chunks;
  - no fallback hides the device: ``--device cuda`` and ``--kernels cuda``
    raise here (``--config conv`` too: no fused kernel trains an image
    corpus).
"""

import dataclasses
import json
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu._scripts import bench as jax_bench  # noqa: E402
from vae_training_tpu_torch._scripts import bench  # noqa: E402

SOLO = ("linear", "sigmoid", "sphere")
GRIDS = ("grid_linear", "grid_sigmoid", "grid_sphere")


def test_configs_and_seeds_are_the_jax_benchs():
    assert bench.CONFIGS == jax_bench.CONFIGS
    assert bench.CONFIG_SEEDS == jax_bench.CONFIG_SEEDS
    assert bench.GRID_FAMILIES == jax_bench.GRID_FAMILIES
    assert set(bench.METRIC_NAMES) == set(jax_bench.METRIC_NAMES)
    for config, name in bench.METRIC_NAMES.items():
        assert jax_bench.METRIC_NAMES[config] == name + "_per_chip"


@pytest.mark.parametrize("config", SOLO)
@pytest.mark.parametrize("adam_dtype", ["f32", "bf16"])
def test_make_cfg_matches_the_jax_make_cfg(config, adam_dtype):
    port = bench.make_cfg(config, "auto", "bf16", adam_dtype, device="cpu")
    ref = jax_bench.make_cfg(config, "auto", "bf16", adam_dtype)
    port_fields = {f.name for f in dataclasses.fields(port)}
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    assert port_fields - ref_fields == {"device"} and not ref_fields - port_fields
    for name in ref_fields:
        assert getattr(port, name) == getattr(ref, name), name


def test_mlp_and_conv_flops_hand_cases():
    for dual in (False, True):
        args = (10, 4, 3, (5, 3), (5, 4), dual)
        assert bench.mlp_step_flops(*args) == jax_bench.mlp_step_flops(*args)
    assert bench.mlp_step_flops(10, 4, 3, (5, 3), (5, 4), dual=False) == 4200
    feats = (200, 200, 200, 6)
    assert bench.mlp_step_flops(100, 6, 6, feats, feats, False) == \
        jax_bench.mlp_step_flops(100, 6, 6, feats, feats, False)
    assert bench.conv_step_flops(1, (4, 4, 1), 3, (2,)) == 1152 == \
        jax_bench.conv_step_flops(1, (4, 4, 1), 3, (2,))
    assert bench.conv_step_flops(128, (28, 28, 1), 16, (32, 64)) == \
        jax_bench.conv_step_flops(128, (28, 28, 1), 16, (32, 64))


def test_workload_flops_plumbing_matches_the_jax_function():
    model = SimpleNamespace(encoder_features=(5, 3), decoder_features=(5, 4),
                            dual_sigmoid_decoder=False, latent_dim=3)
    solo = SimpleNamespace(model=model, dataset=SimpleNamespace(dimension=4),
                           cfg=SimpleNamespace(batch_size=10))
    g = SimpleNamespace(model=model, data_dim=4, latent_dim=3,
                        cfg=SimpleNamespace(batch_size=10), seeds=[1, 2, 3])
    grid = SimpleNamespace(groups=[g, g])
    for config, obj in (("linear", solo), ("grid_linear", grid), ("grid", grid)):
        assert bench.workload_flops_per_step(config, obj) == \
            jax_bench.workload_flops_per_step(config, obj) == 4200


@pytest.fixture(scope="module")
def built():
    """{config: (port object, JAX object)}: every config built by both
    benches on the CPU (the JAX side on its XLA path)."""
    out = {}
    for config in SOLO:
        out[config] = (bench.build("auto", config, device="cpu"),
                       jax_bench.build("xla", config))
    for config in GRIDS:
        family = bench.GRID_FAMILIES[config]
        out[config] = (bench.build_grid("auto", family=family, device="cpu"),
                       jax_bench.build_grid("xla", family=family))
    return out


@pytest.mark.parametrize("config", SOLO + GRIDS)
def test_workload_flops_equal_the_jax_benchs(built, config):
    port, ref = built[config]
    flops = bench.workload_flops_per_step(config, port)
    assert flops == jax_bench.workload_flops_per_step(config, ref)
    assert flops > 0
    if config in GRIDS:
        assert port.n_rows == ref.n_rows == {"grid_linear": 21, "grid_sigmoid": 18,
                                             "grid_sphere": 15}[config]


def test_measure_on_the_cpu_returns_positive_rates(built):
    trainer = built["linear"][0]
    step0 = trainer.state.step
    rates, chunks = bench.measure(trainer, chunk_steps=3, n_windows=2, min_seconds=0.01)
    assert len(rates) == 2 and all(r > 0 for r in rates)
    assert trainer.state.step == step0 + 3 * chunks  # the state chained through
    sweep = built["grid_linear"][0]
    rates, chunks = bench.measure_grid(sweep, chunk_steps=1, n_windows=1, min_seconds=0.0)
    assert len(rates) == 1 and rates[0] > 0 and chunks == 2
    assert {int(s.step) for g in sweep.groups for s in g.states} == {2}


def test_peaks_by_device_name():
    assert bench.peaks("NVIDIA H100 80GB HBM3") == (989.4e12, 67e12)
    assert bench.peaks("NVIDIA H100 PCIe")[0] == 756e12
    assert bench.peaks("NVIDIA H100 NVL")[0] == 835e12
    assert bench.peaks("NVIDIA A100-SXM4-80GB") is None


def test_cli_on_the_cpu_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setitem(bench.CHUNK_STEPS, "sigmoid", 2)
    monkeypatch.setattr(bench, "windows", _short_windows)
    assert bench.main(["--config", "sigmoid", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    (line,) = out.strip().splitlines()
    got = json.loads(line)
    assert got["metric"] == "sigmoid_vae_train_steps_per_sec_on_cpu"
    assert got["value"] > 0 and got["unit"] == "steps/sec"
    assert got["flops_per_step"] == 75600 and got["mfu_pct"] is None
    assert got["device"] == "cpu" and got["power_limit_w"] is None
    assert "[kernels] torch: plain PyTorch path" in err and "windows of >= 1 s" in err


def test_min_floor_exits_3_with_the_json_line(capsys, monkeypatch):
    monkeypatch.setitem(bench.CHUNK_STEPS, "linear", 2)
    monkeypatch.setattr(bench, "windows", _short_windows)
    assert bench.main(["--device", "cpu", "--min", "1e12"]) == 3
    out, err = capsys.readouterr()
    assert json.loads(out)["value"] > 0 and "PERF REGRESSION" in err


def _short_windows(call, steps_per_call, device, n_windows=5, min_seconds=1.0):
    return _windows(call, steps_per_call, device, n_windows, 0.0)


_windows = bench.windows


@pytest.mark.parametrize("argv,exc,match", [
    (["--config", "conv", "--device", "cpu", "--kernels", "cuda"], RuntimeError,
     "--kernels cuda requested"),
    (["--config", "linear"], RuntimeError, "no CUDA device"),
    (["--config", "sphere", "--device", "cpu", "--kernels", "cuda"], RuntimeError,
     "--kernels cuda requested"),
    (["--config", "grid_linear", "--device", "cpu", "--kernels", "cuda"], RuntimeError,
     "--kernels cuda requested"),
])
def test_no_fallback_hides_the_device(argv, exc, match):
    if torch.cuda.is_available() and "cpu" not in argv:
        pytest.skip("this host has a CUDA device")
    with pytest.raises(exc, match=match):
        bench.main(argv)
