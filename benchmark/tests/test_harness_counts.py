"""The benchmark's own counts of operations and bytes, its peaks, and the
reduction of a trace, on hand-worked inputs."""

import pytest

from benchmark import counts
from benchmark.trace import Trace

SPHERE = {"encoder_layer_sizes": "200|200|200", "layer_sizes": "200|200|200",
          "batch_size": 100, "tunable_decoder_var": True}
LINEAR = {"encoder_layer_sizes": "", "layer_sizes": "", "batch_size": 100,
          "tunable_decoder_var": True}


@pytest.mark.parametrize("config,D,L,flops", [
    # 3 × 2·100·(6·200 + 200·200 + 200·200 + 200·6) × 2 stacks
    (SPHERE, 6, 6, 98_880_000),
    # 3 × 2·100·(12·20) × 2 stacks
    (LINEAR, 12, 20, 288_000),
])
def test_row_step_flops(config, D, L, flops):
    assert counts.row_step_flops(config, D, L) == flops


def test_mlp_step_flops_dual_counts_two_decoders():
    one = counts.mlp_step_flops(100, 7, 6, (6,), (7,))
    assert counts.mlp_step_flops(100, 7, 6, (6,), (7,), dual=True) == one * 3 // 2


def test_params_and_bytes():
    # sphere row 1: 6·200+200 + 2·(200·200+200) + 200·6+6, twice, + L + 1
    n = 2 * (1400 + 2 * 40200 + 1206) + 6 + 1
    assert counts.n_params(6, 6, (200, 200, 200), (200, 200, 200)) == n
    got = counts.launch_step_bytes([(6, 6)], (200, 200, 200), (200, 200, 200), 5000)
    assert got == pytest.approx(2 * 12 * n / 5000 + 4)


def test_peaks_by_name_and_roofline():
    assert counts.peaks("NVIDIA H100 80GB HBM3") == (989.4e12, 3.35e12)
    assert counts.peaks("a card not listed") is None
    # 989.4 GFLOP at the peak take 1 ms: a 2 ms kernel reads 50%
    assert counts.roofline_pct(989.4e9, 1.0, 2e-3, "NVIDIA H100 80GB HBM3") == pytest.approx(50)
    # bytes bound: 3.35 GB take 1 ms
    assert counts.roofline_pct(1.0, 3.35e9, 4e-3, "NVIDIA H100 80GB HBM3") == pytest.approx(25)
    assert counts.roofline_pct(1.0, 1.0, 0.0, "NVIDIA H100 80GB HBM3") is None


def _event(name, ts, dur, cat):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat}


def test_trace_reduction():
    events = [
        _event("bench.window", 0, 100, "user_annotation"),
        _event("bench.chunk", 0, 60, "user_annotation"),
        _event("bench.eval", 60, 40, "user_annotation"),
        _event("mlp_vae_chunk_kernel<true>", 5, 40, "kernel"),
        _event("mlp_vae_chunk_kernel<true>", 40, 10, "kernel"),  # overlaps the first
        _event("Memcpy DtoH", 52, 3, "gpu_memcpy"),
        _event("elementwise", 70, 10, "kernel"),
        _event("before", -10, 5, "kernel"),  # outside the window
    ]
    t = Trace(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((45 + 3 + 10) * 1e-6)
    assert t.kernel_seconds("mlp_vae_chunk_kernel") == pytest.approx(50e-6)
    gaps = dict(t.idle_gaps())
    # idle gaps 0-5 and 50-52 in the chunk; 55-70 (its midpoint in the
    # eval) and 80-100 in the eval
    assert gaps["bench.chunk"] == pytest.approx(7e-6)
    assert gaps["bench.eval"] == pytest.approx(35e-6)
    ops = dict(t.device_ops())
    assert ops["mlp_vae_chunk_kernel<true>"] == pytest.approx(50e-6)
    assert "before" not in ops
