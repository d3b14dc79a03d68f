"""Two builds of csrc/probes.cu on one card, in one process: bits and times
in turns.

    # in a git checkout, on any host: the other file, from OTHER_COMMIT
    python -m vae_training_tpu_torch.tools.compare_probe_builds \\
        --write-other build/parent/probes.cu
    # on the card
    python -m vae_training_tpu_torch.tools.compare_probe_builds \\
        --other build/parent/probes.cu [--seconds 0.25]

``--other PATH`` is another version of ``csrc/probes.cu`` with this tree's C
interface, built beside the repository's library (``_build.load_library(...,
source=PATH)``; ``csrc/`` stays on its include path). ``--write-other PATH``
writes one: ``OTHER_COMMIT``'s ``csrc/probes.cu`` (``git show``) with this
tree's interface patched in by ``with_this_interface``, its kernel bodies
left alone, and prints the file's sha256. That commit holds the fp32 phase
body and the bf16 cluster body before their redesign; its interface lacks
the cluster entry without the plan's shared bytes and grid (the library's
constants since), which its bodies do not read. The tool

- holds the builds to each other on the same inputs: the bodies this tree
  did not redesign (``SAME_BITS``: the fp32 cluster and stream forms, the
  bf16 phase and stream forms) bitwise; the redesigned ones' bits are
  printed too (they sum in another order), with each build's ρ one dense
  dot deep against the plain bf16 version (ρ = ‖kernel − plain_bf16‖ /
  ‖plain_fp32 − plain_bf16‖);
- times every form of T3, T4 and T5 in both dot modes with each build in
  turn (this, other, other, this), in the tools' windows (``seconds_per_step``,
  CUDA events, a sync a call): ns a dot (T3), µs a step (T4, T5).

The splits of a dot or step by launch variants are ``chip_smoke.py``'s
(phases 26-28), run on each tree.

The card's name and power limit come first; one JSON line of every number
comes last.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from ..kernels import probes
from ..kernels._build import load_library
from . import probe_adam_overlap as t5
from . import probe_mlp_interleave as t4
from . import probe_mxu_pipelining as t3
from ._common import DOT_MODES, card, device_from, seconds_per_step

ORDER = ("this", "other", "other", "this")
ROOT = Path(__file__).resolve().parents[2]
SOURCE = "vae_training_tpu_torch/csrc/probes.cu"
OTHER_COMMIT = "bd9a8ea"  # the fp32 phase and bf16 cluster bodies before their redesign
# the forms whose bodies this tree keeps: (probe, form, dot mode) bitwise OTHER_COMMIT's
SAME_BITS = {("T4", "cluster", "fp32"), ("T3", "stream", "fp32"), ("T5", "stream", "fp32"),
             ("T4", "phase", "bf16"), ("T3", "phase", "bf16"), ("T3", "stream", "bf16"),
             ("T5", "phase", "bf16"), ("T5", "stream", "bf16")}

# (old, new) pairs that give OTHER_COMMIT's csrc/probes.cu this tree's C
# interface: the cluster entry takes the chain count and the dot mode, not
# the plan's shared bytes and grid
INTERFACE_PATCH = (
    ("""int probes_chain_cluster(const float* x, const float* w, float* out, int n_chains,
                         int n_steps, int depth, int smem, int grid, int upto, int bf16_dots,
                         void* stream) {""",
     """int probes_chain_cluster(const float* x, const float* w, float* out, int n_chains,
                         int n_steps, int depth, int upto, int bf16_dots, void* stream) {"""),
    ("""  if (!chain_plan(n_chains, &p) || p.smem != smem || p.grid != grid || n_steps < 1 ||""",
     """  if (!chain_plan(n_chains, &p) || n_steps < 1 ||"""),
)


def with_this_interface(src: str) -> str:
    """``src``, an older csrc/probes.cu, with ``INTERFACE_PATCH`` applied;
    each old text must occur exactly once."""
    for old, new in INTERFACE_PATCH:
        if src.count(old) != 1:
            raise ValueError(f"the interface patch does not fit this file: {old[:60]!r}...")
        src = src.replace(old, new)
    return src


def write_other(path: str) -> str:
    """Write OTHER_COMMIT's csrc/probes.cu with this tree's interface to
    ``path``; returns its sha256."""
    src = subprocess.run(["git", "show", f"{OTHER_COMMIT}:{SOURCE}"], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(with_this_interface(src))
    return hashlib.sha256(out.read_bytes()).hexdigest()


def _rho(got, ref, other) -> float:
    got, ref, other = (t.double() for t in (got, ref, other))
    return float((got - ref).norm() / (other - ref).norm())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--other", help="another version of csrc/probes.cu, to compare on the card")
    what.add_argument("--write-other", metavar="PATH",
                      help=f"write commit {OTHER_COMMIT}'s csrc/probes.cu with this tree's "
                           "interface to PATH")
    ap.add_argument("--seconds", type=float, default=0.25,
                    help="the least length of each timed window (default 0.25 s)")
    args = ap.parse_args(argv)
    if args.write_other:
        digest = write_other(args.write_other)
        print(f"{args.write_other}: {OTHER_COMMIT}:{SOURCE} with this tree's interface, "
              f"sha256 {digest}")
        return {"other": args.write_other, "commit": OTHER_COMMIT, "sha256": digest}
    dev = device_from("cuda")
    print(f"card: {card(dev)}")
    digest = hashlib.sha256(Path(args.other).read_bytes()).hexdigest()
    print(f"other: {args.other}, sha256 {digest}")
    libs = {"this": probes._lib(),
            "other": probes.bind(load_library("probes", source=args.other)[0])}
    report: Dict[str, object] = {"card": card(dev), "other_sha256": digest}

    def use(name):
        probes._LIB = libs[name]

    # --- bits ------------------------------------------------------------------
    def both(fn):
        """fn() under each build, from fresh inputs: the two results."""
        out = []
        for name in ("this", "other"):
            use(name)
            out.append(fn())
        use("this")
        torch.cuda.synchronize()
        return out

    bits = {}
    for n in (1, 4):
        for mode, bf16 in DOT_MODES.items():
            for form in probes.T4_FORMS:
                xs, ws = t4.check_inputs(n, dev)
                a, b = both(lambda: probes.chain_chunk(
                    xs, ws, n_steps=1, depth=8, weights_per_depth=False, epilogue="clamp",
                    form=form, bf16_dots=bf16))
                bits[f"T4 {form} {mode} {n}"] = torch.equal(a, b)
            for form in probes.T3_FORMS:
                xs, ws = t3.inputs(n, dev)
                a, b = both(lambda: probes.chain_chunk(
                    xs, ws, n_steps=2, depth=probes.T3_DEPTH, weights_per_depth=True,
                    epilogue="renorm", form=form, bf16_dots=bf16))
                bits[f"T3 {form} {mode} {n}"] = torch.equal(a, b)
    for mode, bf16 in DOT_MODES.items():
        for form in probes.T5_FORMS:
            for interleave in (False, True):
                def t5_run():
                    kb = t5.check_inputs(dev)
                    h = probes.adam_overlap_chunk(*kb, n_steps=3, interleave=interleave,
                                                  form=form, bf16_dots=bf16)
                    return torch.cat([h.flatten()] + [t.flatten() for t in kb[1:]])
                a, b = both(t5_run)
                bits[f"T5 {form} {'interleaved' if interleave else 'tail'} {mode}"] = \
                    torch.equal(a, b)
    def kept_body(key):
        probe, form, *rest = key.split()
        return (probe, form, next(w for w in rest if w in DOT_MODES)) in SAME_BITS

    for key, same in bits.items():
        print(f"bits, this = other: {key}: {same} "
              f"({'kept body' if kept_body(key) else 'redesigned'})")
    kept = [same for key, same in bits.items() if kept_body(key)]
    print(f"bits: every kept body equals the other build's: {all(kept)} ({len(kept)} cases)")
    report["bits_equal"] = bits
    report["kept_bodies_bitwise"] = all(kept)
    # one dense dot deep, each build's bf16 bodies against the plain version
    rhos = {}
    for n in (1, 4):
        one4 = dict(n_steps=1, depth=1, weights_per_depth=False, epilogue="clamp")
        one3 = dict(n_steps=1, depth=1, weights_per_depth=True, epilogue="renorm")
        trip = dict(n_steps=1, depth=probes.T3_DEPTH, weights_per_depth=True, epilogue="renorm")
        cases = [("T4", t4.check_inputs(n, dev), one4, probes.T4_FORMS),
                 ("T3", (lambda x, w: (x, w[:, :probes.W].contiguous()))(*t3.inputs(n, dev)),
                  one3, ("phase",)),
                 ("T3 trip", t3.dense_trip_inputs(n, dev), trip, ("stream",))]
        for label, (xs, ws), kw, forms in cases:
            want = probes.plain_chain_chunk(xs, ws, bf16_dots=True, **kw)
            f32 = probes.plain_chain_chunk(xs, ws, **kw)
            for form in forms:
                got = both(lambda: probes.chain_chunk(xs, ws, form=form, bf16_dots=True, **kw))
                for name, g in zip(("this", "other"), got):
                    rhos[f"{label} {form} {n} {name}"] = r = _rho(g, want, f32)
                    print(f"rho one dense dot, {label} {form}, {n} chain(s), {name}: {r:.3e}")
    report["rho_one_dot"] = rhos

    # --- times in turns --------------------------------------------------------
    def window(fn):
        return seconds_per_step(fn, dev, args.seconds)[0]

    times = {}

    def in_turns(key, fn, scale):
        got = {"this": [], "other": []}
        for name in ORDER:
            use(name)
            got[name].append(scale * window(fn))
        use("this")
        times[key] = {k: min(v) for k, v in got.items()}
        print(f"{key}: this {times[key]['this']:.3f}, other {times[key]['other']:.3f} "
              f"(this/other {times[key]['this'] / times[key]['other']:.3f}; min of two each)")

    for mode, bf16 in DOT_MODES.items():
        for n in (1, 4):
            for form in probes.T4_FORMS:
                xs, ws = t4.inputs(n, dev)
                in_turns(f"T4 {form} {mode} {n} chain(s), us a step", lambda k, f=form: (
                    probes.chain_chunk(xs, ws, n_steps=k, depth=probes.T4_DEPTH,
                                       weights_per_depth=False, epilogue="clamp", form=f,
                                       bf16_dots=bf16)), 1e6)
            for form in probes.T3_FORMS:
                xs, ws = t3.inputs(n, dev)
                in_turns(f"T3 {form} {mode} {n} chain(s), ns a dot", lambda k, f=form: (
                    probes.chain_chunk(xs, ws, n_steps=k, depth=probes.T3_DEPTH,
                                       weights_per_depth=True, epilogue="renorm", form=f,
                                       bf16_dots=bf16)), 1e9 / (probes.T3_DEPTH * n))
        for form in probes.T5_FORMS:
            for interleave in (False, True):
                kb = t5.inputs(dev)
                done = [0]

                def t5_launch(k, f=form, il=interleave, kb=kb, done=done):
                    probes.adam_overlap_chunk(*kb, n_steps=k, interleave=il, t0=done[0],
                                              form=f, bf16_dots=bf16)
                    done[0] += k
                in_turns(f"T5 {form} {'interleaved' if interleave else 'tail'} {mode}, "
                         "us a step", t5_launch, 1e6)
    report["times"] = times

    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
