"""``benchmark/program_spans.py``: the program's span records joined to a
traced window, on a synthetic trace (the clocks' offset and its error,
idle time by innermost span against a tick-by-tick count, the
unattributed share, the per-chunk, per-round and per-event readers), and
a CPU run of a small ``cadence`` cell that reads every new metric."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import program_spans
from benchmark.run import reader
from benchmark.trace import Trace

REPO = Path(__file__).resolve().parents[2]
NEW = ["chunk_pack_idle_ms", "chunk_launch_idle_ms", "chunk_finish_idle_ms",
       "eval_draw_idle_ms", "eval_forward_idle_ms", "eval_host_idle_ms", "save_copy_ms",
       "save_queue_wait_ms", "idle_unattributed_pct"]
OFFSET = 500.0  # trace µs minus program µs
MAIN, WRITER = 1, 2


class Rec(SimpleNamespace):
    pass


def synthetic():
    """A 4 ms window: three chunks (pack with a device copy inside it,
    launch, the kernel, unpack, the losses), an eval round with a kernel
    in its forward, a save event; a writer-thread span and a span before
    the window, which count for nothing."""
    t0, t1 = 10000.0, 14000.0
    events = [{"name": "bench.window", "cat": "user_annotation", "ts": t0, "dur": t1 - t0}]
    records, chunk_spans, rid = [], [], iter(range(1000))

    def rec(name, s, e, parent=None, thread=MAIN, tag=None):
        r = Rec(id=next(rid), name=name, start_ns=int((s - OFFSET) * 1e3),
                end_ns=int((e - OFFSET) * 1e3), parent=parent, thread=thread, tag=tag)
        records.append(r)
        return r.id

    def busy(s, e, name="k"):
        events.append({"name": name, "cat": "kernel", "ts": s, "dur": e - s})

    for b in (10010.0, 11010.0, 12010.0):
        events.append({"name": "bench.chunk", "cat": "user_annotation", "ts": b, "dur": 980.0})
        chunk_spans.append(((b - OFFSET) / 1e6, (b + 980 - OFFSET) / 1e6, None))
        c = rec("sweep.chunk", b + 2, b + 978)
        rec("chunk.pack", b + 10, b + 100, c)
        busy(b + 50, b + 60, "copy")
        rec("chunk.launch", b + 100, b + 200, c)
        busy(b + 190, b + 880)
        rec("chunk.unpack", b + 200, b + 600, c)
        rec("chunk.losses", b + 880, b + 950, c)
    ev = rec("sweep.eval", 13000, 13900, tag=5000)
    rec("eval.draw", 13010, 13300, ev)
    rec("eval.forward", 13300, 13600, ev)
    busy(13400, 13500)
    rec("eval.to_host", 13600, 13800, ev)
    sv = rec("sweep.save", 13900, 13990, tag=50000)
    rec("save.copy", 13900, 13940, sv)
    rec("save.submit", 13940, 13980, sv)
    rec("writer.job", 10000, 14000, thread=WRITER)
    rec("sweep.chunk", 9000, 9500)  # before the window
    return Trace(events), chunk_spans, records


def by_ticks(trace, records):
    """Idle µs by innermost main-thread span, one tick a µs (the
    reference)."""
    busy = trace.busy_intervals()
    mine = [r for r in records if r.thread == MAIN]
    out = {}
    t = trace.t0 + 0.5
    while t < trace.t1:
        if not any(s <= t < e for s, e in busy):
            covering = [r for r in mine
                        if r.start_ns / 1e3 + OFFSET <= t < r.end_ns / 1e3 + OFFSET]
            name = (max(covering, key=lambda r: (r.start_ns, -r.end_ns)).name if covering
                    else None)
            out[name] = out.get(name, 0) + 1
        t += 1.0
    return out


def test_the_join_aligns_the_clocks_and_attributes_idle_time():
    trace, chunk_spans, records = synthetic()
    j = program_spans.Join(trace, chunk_spans, records)
    assert j.offset_us == pytest.approx(OFFSET, abs=1e-6)
    assert j.alignment_error_us == pytest.approx(0.0, abs=1e-6)
    assert j.thread == MAIN
    want = by_ticks(trace, records)
    got = {k: round(v, 6) for k, v in j.idle_us.items()}
    assert got == {k: v for k, v in want.items() if k is not None}
    assert j.unattributed_us == pytest.approx(want[None], abs=1e-6)
    assert j.idle_total_us == pytest.approx(sum(want.values()), abs=1e-6)
    assert j.unattributed_ends_us == pytest.approx(12 + 10, abs=1e-6)  # 10000-10012, 13990-
    # by hand: a pack of 90 µs with a 10 µs copy in it; the launch up to
    # its kernel; the unpack's 400 µs under the kernel
    assert got["chunk.pack"] == 3 * 80 and got["chunk.launch"] == 3 * 90
    assert "chunk.unpack" not in got and got["chunk.losses"] == 3 * 70
    assert got["eval.forward"] == 200 and got["save.submit"] == 40
    assert j.count["sweep.chunk"] == 3 and j.count["sweep.eval"] == 1  # not the one before


def test_an_outlying_offset_moves_the_error_not_the_offset():
    """Five chunks, the middle one's reading 30 µs late (a pause between
    the harness's two clocks): the median offset holds, the error reads
    30 µs."""
    starts = [20000.0 + 1000.0 * i for i in range(5)]
    late = [30.0 if i == 2 else 0.0 for i in range(5)]
    events = [{"name": "bench.window", "cat": "user_annotation", "ts": 19000.0, "dur": 7000.0}]
    events += [{"name": "bench.chunk", "cat": "user_annotation", "ts": s + OFFSET + d,
                "dur": 900.0} for s, d in zip(starts, late)]
    j = program_spans.Join(Trace(events), [(s / 1e6, (s + 900) / 1e6, None) for s in starts],
                           [])
    assert j.offset_us == pytest.approx(OFFSET, abs=1e-6)
    assert j.alignment_error_us == pytest.approx(30.0, abs=1e-6)
    assert j.thread is None


def test_the_readers_divide_by_chunks_rounds_and_events(monkeypatch):
    trace, chunk_spans, records = synthetic()
    monkeypatch.setattr(program_spans, "program_records", lambda: records)
    run = SimpleNamespace(trace=trace, spans=SimpleNamespace(spans={"chunk": chunk_spans}))
    got = {name: reader(name)(run) for name in NEW}
    want_unattributed = 100.0 * by_ticks(trace, records)[None] / (
        sum(by_ticks(trace, records).values()))
    assert got == pytest.approx({
        "chunk_pack_idle_ms": 0.080, "chunk_launch_idle_ms": 0.090,
        "chunk_finish_idle_ms": 0.070, "eval_draw_idle_ms": 0.290,
        "eval_forward_idle_ms": 0.200, "eval_host_idle_ms": 0.200, "save_copy_ms": 0.040,
        "save_queue_wait_ms": 0.040, "idle_unattributed_pct": want_unattributed})


def test_nothing_to_read_without_the_programs_records(monkeypatch):
    trace, chunk_spans, _ = synthetic()
    run = SimpleNamespace(trace=trace, spans=SimpleNamespace(spans={"chunk": chunk_spans}))
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    assert [reader(name)(run) for name in NEW] == [None] * len(NEW)


def test_chunk_counts_that_differ_are_refused():
    trace, chunk_spans, records = synthetic()
    with pytest.raises(ValueError, match="bench.chunk"):
        program_spans.Join(trace, chunk_spans[:-1], records)


def test_a_cpu_cadence_run_reads_every_new_metric(tmp_path):
    """The ``cadence`` cell at a tiny size (one sphere row, an eval every 2
    steps, a save every 4), traced: each new metric of the cell reads a
    value."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "benchmark" / "workloads" / "sphere_sweep.tiny.json").write_text(json.dumps(dict(
        json.loads((REPO / "benchmark" / "workloads" / "sphere_sweep.cadence.json").read_text()),
        rows=[[3, 3, 6]], dataset_seeds=[69], n_print=2, n_plot=4, chunk_steps=2)))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sphere_sweep.tiny", "config": "sphere_sweep",
                               "traffic": "tiny", "chips": 1, "why": "a test's cell"})
    for m in bench["per_layer"]:
        if "sphere_sweep.cadence" in m["workloads"]:
            m["workloads"].append("sphere_sweep.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(root), str(REPO)]))
    out = subprocess.run([sys.executable, "benchmark/tests/_cpu_run.py", "sphere_sweep.tiny",
                          "2147483999", "0.5", "--trace", "1"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
    for name in NEW:
        assert isinstance(metrics[name]["value"], float), name
    assert 0.0 <= metrics["idle_unattributed_pct"]["value"] <= 5.0
    assert "[bench] program spans:" in out.stderr and "alignment error" in out.stderr
