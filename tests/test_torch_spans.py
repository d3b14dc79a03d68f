"""The port's spans (``utils/spans.py``) on the CPU: off outside a
profiler but for the totals; under one, records with their parents, tags
and threads, and the same names as ranges in the Chrome trace; the
sweep's spans nested as the benchmark's readers expect, the wall
accounting line printed from them; and a full writer queue's wait inside
``save.submit``."""

import json
import re
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from vae_training_tpu_torch.utils import spans  # noqa: E402
from vae_training_tpu_torch.utils.spans import span  # noqa: E402


@pytest.fixture(autouse=True)
def cleared():
    spans.clear()
    yield
    spans.clear()


def test_outside_a_profiler_only_the_totals_count(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called outside a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for _ in range(3):
        with span("outer", tag=1):
            with span("inner"):
                pass
    assert spans.records() == []
    got = spans.totals()
    assert set(got) == {"outer", "inner"}
    assert got["outer"][0] == got["inner"][0] == 3
    assert got["outer"][1] >= got["inner"][1] >= 0.0
    assert spans.seconds("outer") == got["outer"][1] and spans.seconds("absent") == 0.0


def test_under_a_profiler_records_and_trace_ranges(tmp_path):
    seen = {}

    def worker():
        seen["thread"] = threading.get_ident()
        with span("other", tag="w"):
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", tag=7):
            with span("inner"):
                torch.ones(4).sum()
            t = threading.Thread(target=worker)
            t.start()
            t.join(10)
        assert not t.is_alive()
    with span("after"):  # the profiler is off again: counted, not recorded
        pass
    recs = {r.name: r for r in spans.records()}
    assert set(recs) == {"outer", "inner", "other"}
    outer, inner, other = recs["outer"], recs["inner"], recs["other"]
    assert inner.parent == outer.id and outer.parent is None and other.parent is None
    assert (outer.tag, inner.tag, other.tag) == (7, None, "w")
    assert outer.thread == inner.thread == threading.get_ident() != other.thread
    assert other.thread == seen["thread"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert [r.name for r in spans.records()][:2] == ["outer", "inner"]
    assert spans.totals()["after"][0] == 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= names  # the profiling thread's


def test_a_profiled_sweep_nests_its_spans(tmp_path, capsys):
    """A 3-step grouped linear sweep (one row group of 3 seeds, K6a's plain
    version) under the profiler: every chunk, eval and save span inside its
    sweep span, and the wall accounting lines equal the totals."""
    from vae_training_tpu_torch._scripts import sweep

    with profile(activities=[ProfilerActivity.CPU]):
        assert sweep.main(["linear", "--grouped", "--num_batches", "3", "--device", "cpu",
                           "--shard", "1/7", "--data_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    recs = spans.records()
    by_id = {r.id: r for r in recs}
    names = {r.name for r in recs}
    inside = {"chunk.pack": "sweep.chunk", "chunk.launch": "sweep.chunk",
              "chunk.unpack": "sweep.chunk", "chunk.losses": "sweep.chunk",
              "eval.draw": "sweep.eval", "eval.forward": "sweep.eval",
              "eval.to_host": "sweep.eval",
              "save.copy": ("sweep.save", "sweep.final_save"),
              "save.submit": ("sweep.save", "sweep.final_save")}
    assert set(inside) <= names
    for r in recs:
        if r.name in inside:
            parent = by_id[r.parent]
            assert parent.name in inside[r.name], (r.name, parent.name)
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    # an eval round at step 0, plot+save at 0 and at the last step, 2; chunks 0-2 and 2-3
    assert [r.tag for r in recs if r.name == "sweep.eval"] == [0]
    assert [r.tag for r in recs if r.name == "sweep.save"] == [0, 2]
    assert sum(r.name == "sweep.chunk" for r in recs) == 2
    assert sum(r.name == "eval.draw" for r in recs) == 3
    assert not any(r.name.startswith("bench.") for r in recs)

    line = re.search(r"^\[sweep\] wall accounting: banners ([\d.]+)s, train chunks ([\d.]+)s, "
                     r"stat evals ([\d.]+)s, plot\+save ([\d.]+)s over 3 rows", out, re.M)
    assert line
    sec = {k: v[1] for k, v in spans.totals().items()}
    want = (sec["sweep.banner"], sec["sweep.chunk"], sec["sweep.eval"],
            sec["sweep.save"] + sec["sweep.drain"])
    assert [float(x) for x in line.groups()] == [float(f"{w:.3f}") for w in want]
    setup = re.search(r"^\[sweep\] wall accounting: setup ([\d.]+)s, final saves ([\d.]+)s$",
                      out, re.M)
    assert setup and [float(x) for x in setup.groups()] == [
        float(f"{sec[k]:.3f}") for k in ("sweep.setup", "sweep.final_save")]


def test_a_full_writer_queue_waits_inside_save_submit(tmp_path, monkeypatch):
    """Ten rows' saves into the writer's 8 slots while its first job
    sleeps: the tenth submit waits for it, inside ``save.submit``."""
    from vae_training_tpu_torch.config import parse_arguments
    from vae_training_tpu_torch.runio.background import ArtifactWriter
    from vae_training_tpu_torch.train import grid

    cfg = parse_arguments(["spans", "--dataset", "linear_gaussian", "--encoder_layer_sizes", "",
                           "--layer_sizes", "", "-ow", "--latent_dim", "4", "--padding_dim",
                           "2", "-dd", "2", "--epsilon", "-1", "-tdv", "--batch_size", "8",
                           "--num_batches", "10", "--device", "cpu", "--data_dir",
                           str(tmp_path)])
    cfg.tqdm = False
    trainer = grid.GridTrainer(cfg.validate(), seeds=list(range(10)), build_chunk=False)
    writer = ArtifactWriter()
    monkeypatch.setattr(grid, "get_artifact_writer", lambda: writer)
    sleeps = [0.4] + [0.0] * 9

    def slow_checkpoint(*a, **kw):
        time.sleep(sleeps.pop(0))

    monkeypatch.setattr(grid, "save_checkpoint", slow_checkpoint)
    monkeypatch.setattr(grid, "save_model_pkl", lambda *a, **kw: None)
    monkeypatch.setattr(grid.StatsRecorder, "save_npz", lambda self, *a, **kw: None)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("sweep.save", tag=0):
            trainer.save_all([str(tmp_path / f"row{i}") for i in range(10)])
    writer.drain()
    assert sleeps == []
    recs = spans.records()
    submits = [r for r in recs if r.name == "save.submit"]
    copies = [r for r in recs if r.name == "save.copy"]
    assert len(submits) == len(copies) == 10
    waits = [(r.end_ns - r.start_ns) * 1e-9 for r in submits]
    assert waits[-1] >= 0.2 > max(waits[:-1])  # only the tenth finds the queue full
    assert spans.totals()["save.submit"][1] >= 0.2 > spans.totals()["save.copy"][1]
