"""The port's CLI surface: a port of ``tests/test_cli.py`` (flag parity with
the reference, sweep-row parsing, end-to-end tiny runs per dataset, the
output-directory guards), the option strings of both parsers diffed, and
``--profile`` and ``--debug_nans`` on the CPU."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu.config import build_parser as jax_build_parser  # noqa: E402
from vae_training_tpu_torch._scripts.run import cli, main  # noqa: E402
from vae_training_tpu_torch.config import RunConfig, build_parser, parse_arguments  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW1 = ["--dataset", "linear_gaussian", "--encoder_layer_sizes", "", "--layer_sizes", "",
        "-ow", "--latent_dim", "20", "--padding_dim", "9", "-dd", "3", "--epsilon", "-1",
        "-tdv", "-ds", "2", "-lr", "1e-3", "--device", "cpu", "--n_print", "10",
        "--n_plot", "20"]


def test_reference_sweep_row_parses():
    # row 1 of the reference's seed_linpadding_expts.sh
    argv = [
        "vae3linear_gaussian_12dim2", "--dataset", "linear_gaussian",
        "--encoder_layer_sizes", "", "--layer_sizes", "", "-ow",
        "--latent_dim", "20", "--padding_dim", "9", "-dd", "3",
        "--num_batches", "100000", "--epsilon", "-1", "-tdv",
        "-ds", "2", "-lr", "1e-3",
    ]
    cfg = parse_arguments(argv)
    assert cfg.name == "vae3linear_gaussian_12dim2"
    assert cfg.dataset == "linear_gaussian"
    assert cfg.encoder_layer_sizes == "" and cfg.layer_sizes == ""
    assert cfg.latent_dimension == 20 and cfg.padding_dim == 9
    assert cfg.dataset_dimension == 3 and cfg.num_batches == 100000
    assert cfg.epsilon == -1.0 and cfg.tunable_decoder_var
    assert cfg.dataset_seed == 2 and cfg.learning_rate == 1e-3
    assert cfg.model == "VAE" and cfg.latent_distribution == "gaussian"
    assert cfg.device == "cuda"  # the port's default: the card


def test_sphere_sweep_row_parses():
    argv = ("sphere_dd3_pd3_ld_6_eps-3 --dataset sphere --encoder_layer_sizes 200|200|200 "
            "--layer_sizes 200|200|200 -ow --latent_dim 6 --padding_dim 3 -dd 3 "
            "--num_batches 150000 --epsilon -3 -tdv").split()
    cfg = parse_arguments(argv)
    assert cfg.encoder_layer_sizes == "200|200|200"
    assert cfg.epsilon == -3.0


def test_default_dataset_errors_clearly():
    cfg = parse_arguments(["x", "--device", "cpu"])
    with pytest.raises(ValueError, match="4gaussian"):
        cfg.validate()


def test_option_strings_match_the_jax_parser():
    """Both parsers' option strings, diffed: only --device differs."""
    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    port, ref = options(build_parser()), options(jax_build_parser())
    assert port - ref == {"--device"} and not ref - port


@pytest.mark.parametrize("dataset,extra", [
    ("linear_gaussian", ["--latent_dim", "6", "-tdv", "--epsilon", "-1"]),
    ("sigmoid", ["--latent_dim", "6", "-tdv", "--epsilon", "-3"]),
    ("sphere", ["--latent_dim", "4", "--encoder_layer_sizes", "16", "--layer_sizes", "16",
                "--epsilon", "-3", "-tdv"]),
    ("gaussian", ["--latent_dim", "4"]),
])
def test_end_to_end_tiny_run(tmp_path, dataset, extra):
    argv = [f"e2e_{dataset}", "--dataset", dataset, "--num_batches", "60", "--batch_size",
            "20", "--padding_dim", "2", "-dd", "3", "-ow", "--encoder_layer_sizes", "",
            "--layer_sizes", "", "--data_dir", str(tmp_path), "--device", "cpu"] + extra
    assert main(parse_arguments(argv)) == 0
    out = tmp_path / f"e2e_{dataset}"
    assert {"args.json", "losses.npz", "model.pkl", "ckpt.pt"} <= set(os.listdir(out))
    with open(out / "args.json") as f:
        assert json.load(f)["dataset"] == dataset
    z = np.load(out / "losses.npz")
    assert z["VAE Loss"].shape[0] >= 60 and np.all(np.isfinite(z["VAE Loss"]))


def test_overwrite_protection(tmp_path):
    from vae_training_tpu_torch.runio import make_output_dir

    d = str(tmp_path)
    cfg = RunConfig(name="dup", data_dir=d)
    make_output_dir("dup", False, cfg, data_dir=d)
    with pytest.raises(ValueError, match="already exists"):
        make_output_dir("dup", False, cfg, data_dir=d)
    os.makedirs(os.path.join(d, "dup", "sub"), exist_ok=True)
    make_output_dir("dup", True, cfg, data_dir=d)  # -ow clears recursively
    assert os.listdir(os.path.join(d, "dup")) == ["args.json"]


def test_kernels_package_import_is_lazy():
    """Importing the kernels package loads no kernel module (and so builds
    nothing): the CPU tests import it on a host without nvcc."""
    code = ("import sys\n"
            "import vae_training_tpu_torch.kernels\n"
            "assert 'vae_training_tpu_torch.kernels.linear_vae' not in sys.modules\n"
            "assert 'vae_training_tpu_torch.kernels.mlp_vae' not in sys.modules\n"
            "print('LAZYOK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "LAZYOK" in out.stdout


def test_resume_clobber_guards(tmp_path):
    """--resume bypasses clobber protection only when resuming IN PLACE; a
    foreign resume into an existing name needs -ow, and -ow is refused when
    it would wipe the resume source itself."""
    d = str(tmp_path)

    def argv(name, *extra):
        return parse_arguments([name, "--dataset", "linear_gaussian", "--num_batches", "40",
                                "--batch_size", "20", "--padding_dim", "2", "-dd", "3",
                                "--encoder_layer_sizes", "", "--layer_sizes", "",
                                "--device", "cpu", "--data_dir", d, *extra])

    assert main(argv("src", "-ow")) == 0
    src = os.path.join(d, "src")
    assert main(argv("dst", "-ow")) == 0
    with pytest.raises(ValueError, match="already exists"):
        main(argv("dst", "--resume", src))
    assert main(argv("src", "--resume", src, "--num_batches", "60")) == 0
    link = d + "_link"
    if not os.path.exists(link):
        os.symlink(d, link)
    assert main(argv("src", "--resume", os.path.join(link, "src"), "--num_batches", "80")) == 0
    with pytest.raises(ValueError, match="lies inside"):
        main(argv("src", "-ow", "--resume", os.path.join(src, "sub")))


def test_parser_defaults_match_dataclass_defaults():
    fields = {f.name: f for f in dataclasses.fields(RunConfig)}
    checked = 0
    for action in build_parser()._actions:
        if action.dest in ("help", "name") or action.dest not in fields:
            continue
        f = fields[action.dest]
        expected = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        assert action.default == expected, action.dest
        checked += 1
    assert checked >= 25


def _same_run(a, b):
    za, zb = np.load(a / "losses.npz"), np.load(b / "losses.npz")
    assert za.files == zb.files
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with open(a / "model.pkl", "rb") as f:
        pa = pickle.load(f)
    with open(b / "model.pkl", "rb") as f:
        pb = pickle.load(f)
    for k in pa["target"]:
        flat_a, flat_b = _leaves(pa["target"][k]), _leaves(pb["target"][k])
        assert len(flat_a) == len(flat_b)
        for x, y in zip(flat_a, flat_b):
            np.testing.assert_array_equal(x, y, err_msg=k)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def test_profile_traces_one_chunk_and_changes_nothing(tmp_path):
    assert cli(["plain", *ROW1, "--num_batches", "30", "--data_dir", str(tmp_path)]) == 0
    assert cli(["prof", *ROW1, "--num_batches", "30", "--data_dir", str(tmp_path),
                "--profile"]) == 0
    trace = tmp_path / "prof" / "profile" / "trace.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert not (tmp_path / "plain" / "profile").exists()
    _same_run(tmp_path / "plain", tmp_path / "prof")


@pytest.mark.parametrize("grid", [False, True], ids=["solo", "seed_grid"])
def test_debug_nans_clean_run_changes_nothing(tmp_path, grid):
    extra = ["--seed_grid", "2,3"] if grid else []
    assert cli(["a", *ROW1, "--num_batches", "25", "--data_dir", str(tmp_path), *extra]) == 0
    assert cli(["b", *ROW1, "--num_batches", "25", "--data_dir", str(tmp_path), *extra,
                "--debug_nans"]) == 0
    for sub in (["_seed2", "_seed3"] if grid else [""]):
        _same_run(tmp_path / f"a{sub}", tmp_path / f"b{sub}")


def _nan_state_dict(tmp_path):
    assert cli(["src", *ROW1, "--num_batches", "5", "--data_dir", str(tmp_path)]) == 0
    with open(tmp_path / "src" / "model.pkl", "rb") as f:
        sd = pickle.load(f)
    sd["target"]["Decoder"]["FC0"]["kernel"][1, 2] = np.nan
    path = tmp_path / "nan.pkl"
    with open(path, "wb") as f:
        pickle.dump(sd, f)
    return str(path)


def test_debug_nans_raises_on_a_nan_state(tmp_path):
    nan_pkl = _nan_state_dict(tmp_path)
    # without the flag the run goes on and records non-finite losses
    assert cli(["quiet", *ROW1, "--num_batches", "5", "--data_dir", str(tmp_path),
                "--state_dict", nan_pkl]) == 0
    assert not np.all(np.isfinite(np.load(tmp_path / "quiet" / "losses.npz")["VAE Loss"]))
    with pytest.raises(FloatingPointError, match=r"non-finite state at step 0: "
                                                 r"params\[Decoder.FC0.kernel\]"):
        cli(["loud", *ROW1, "--num_batches", "5", "--data_dir", str(tmp_path),
             "--state_dict", nan_pkl, "--debug_nans"])


def test_debug_nans_names_the_step_of_a_non_finite_loss():
    from vae_training_tpu_torch.train.loop import check_finite_losses

    check_finite_losses(np.zeros(4, np.float32), 100)
    with pytest.raises(FloatingPointError, match="loss at step 102"):
        check_finite_losses(np.array([1.0, 2.0, np.inf, np.nan], np.float32), 100)
    with pytest.raises(FloatingPointError, match=r"loss \(row seed 3\) at step 7"):
        check_finite_losses(np.array([np.nan]), 7, " (row seed 3)")


def test_debug_nans_runs_the_torch_path_under_detect_anomaly(tmp_path):
    """On the torch path the backward of a NaN is caught where it arises,
    inside the chunk, by torch.autograd.detect_anomaly."""
    from vae_training_tpu_torch.data import get_dataset
    from vae_training_tpu_torch.kernels.dispatch import make_train_chunk
    from vae_training_tpu_torch.models import build_vae
    from vae_training_tpu_torch.train import TrainState

    cfg = parse_arguments(["t", *ROW1, "--kernels", "torch", "--debug_nans"])
    ds = get_dataset(cfg.dataset, 2, cfg)
    model = build_vae(data_dim=ds.dimension, latent_dim=20, epsilon=-1.0,
                      tunable_decoder_var=True)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 1, 2)
    state.params["Decoder.FC0.kernel"][1, 2] = float("nan")
    with pytest.raises(RuntimeError, match="nan"):
        make_train_chunk(model, ds, cfg)(state, 2)
    cfg.debug_nans = False
    _, losses = make_train_chunk(model, ds, cfg)(state, 2)
    assert not torch.isfinite(losses).any()
