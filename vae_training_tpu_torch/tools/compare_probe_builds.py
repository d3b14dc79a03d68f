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
left alone, and prints the file's sha256. That commit holds the bf16 phase
and stream bodies before their redesign; its interface lacks the
phase form's launch variants (``probes_chain_phase``'s ``upto``) and the
stream entry's ``wb`` argument, which its bodies ignore. The tool

- holds the builds to each other on the same inputs: every fp32
  instantiation and T4's cluster form in bf16 dots bitwise; the other bf16
  bodies' bits are printed (equal where their summation order is the same),
  with each build's ρ one dense dot deep against the plain bf16 version
  (ρ = ‖kernel − plain_bf16‖ / ‖plain_fp32 − plain_bf16‖);
- times every form of T3, T4 and T5 in both dot modes with each build in
  turn (this, other, other, this), in the tools' windows (``seconds_per_step``,
  CUDA events, a sync a call): ns a dot (T3), µs a step (T4, T5);
- splits the stream form's dot (``_stream_launch(upto=...)``) and the
  phase form's (``_phase_launch(upto=...)``), both builds in turns, in
  device time.

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
from ._common import DOT_MODES, card, device_from, seconds_per_step, split_in_turns

ORDER = ("this", "other", "other", "this")
ROOT = Path(__file__).resolve().parents[2]
SOURCE = "vae_training_tpu_torch/csrc/probes.cu"
OTHER_COMMIT = "72ab5c7"  # the bf16 phase and stream bodies before their redesign

# (old, new) pairs that give OTHER_COMMIT's csrc/probes.cu this
# tree's C interface: the phase form's launch variants (the grid barriers
# alone, the work alone, whole) around its unchanged dot bodies, and the
# stream entry's bf16-copy argument, which the older bodies ignore
INTERFACE_PATCH = (
    ("""  int n_chains, n_steps, depth, dots_per_weight, epilogue, adam, t0;
};""", """  int n_chains, n_steps, depth, dots_per_weight, epilogue, adam, t0, upto;
};
constexpr int kPhaseUptoBarriers = 0;
constexpr int kPhaseUptoWork = 1;
constexpr int kPhaseUptoAll = 2;"""),
    ("""  int cur = 0;
  for (int it = 0; it < A.n_steps; ++it) {""", """  const bool work = A.upto != kPhaseUptoBarriers, sync = A.upto != kPhaseUptoWork;
  int cur = 0;
  for (int it = 0; it < A.n_steps; ++it) {"""),
    ("""      float lmax[kMaxChains] = {0.0f, 0.0f, 0.0f, 0.0f};
      if constexpr (kBf16) {""", """      float lmax[kMaxChains] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (!work) {
      } else if constexpr (kBf16) {"""),
    ("""      if (A.epilogue == kEpRenorm && d == A.depth - 1)
        block_max_to_global(lmax, A.maxbits + (it & 1) * A.n_chains, A.n_chains);
      grid.sync();""", """      if (work && A.epilogue == kEpRenorm && d == A.depth - 1)
        block_max_to_global(lmax, A.maxbits + (it & 1) * A.n_chains, A.n_chains);
      if (sync) grid.sync();"""),
    ("""      for (int i = gtid; i < n_h; i += gsz) {
        const float mx""", """      for (int i = gtid; work && i < n_h; i += gsz) {
        const float mx"""),
    ("""      if (gtid < A.n_chains) A.maxbits[((it + 1) & 1) * A.n_chains + gtid] = 0u;
      grid.sync();""", """      if (gtid < A.n_chains) A.maxbits[((it + 1) & 1) * A.n_chains + gtid] = 0u;
      if (sync) grid.sync();"""),
    ("""      const int n_items = (n_buf - first) * kW * kW;
      for (int i = gtid; i < n_items; i += gsz)
        adam_item(A, h, first + i / (kW * kW), i % (kW * kW), bc1, bc2);
      grid.sync();""", """      const int n_items = work ? (n_buf - first) * kW * kW : 0;
      for (int i = gtid; i < n_items; i += gsz)
        adam_item(A, h, first + i / (kW * kW), i % (kW * kW), bc1, bc2);
      if (sync) grid.sync();"""),
    ("""int probes_chain_phase(float* h, float* w, float* m, float* v, unsigned int* maxbits,
                       int n_chains, int n_steps, int depth, int dots_per_weight,
                       int epilogue, int adam, int t0, int bf16_dots, void* stream) {""",
     """int probes_chain_phase(float* h, float* w, float* m, float* v, unsigned int* maxbits,
                       int n_chains, int n_steps, int depth, int dots_per_weight, int epilogue,
                       int adam, int t0, int bf16_dots, int upto, void* stream) {"""),
    ("""  ChainArgs A{h, w, m, v, maxbits, n_chains, n_steps, depth, dots_per_weight, epilogue,
              adam, t0};""", """  ChainArgs A{h, w, m, v, maxbits, n_chains, n_steps, depth, dots_per_weight, epilogue,
              adam, t0, upto};"""),
    ("""int probes_chain_stream(const float* x, float* w, float* m, float* v, float* out, int n_chains,
                        int n_steps, int mode, int t0, int upto, int bf16_dots, void* stream) {""",
     """int probes_chain_stream(const float* x, float* w, void* wb, float* m, float* v, float* out,
                        int n_chains, int n_steps, int mode, int t0, int upto, int bf16_dots,
                        void* stream) {"""),
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
    for key, same in bits.items():
        print(f"bits, this = other: {key}: {same}")
    report["bits_equal"] = bits
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

    # --- splits, device time ---------------------------------------------------
    def builds(launch):
        """``launch(upto)`` under each build, for split_in_turns."""
        def under(name):
            def run(upto):
                use(name)
                return launch(upto)
            return run
        return {name: under(name) for name in ("this", "other")}

    splits = {}
    for mode, bf16 in DOT_MODES.items():
        xs, ws = t3.inputs(1, dev)
        got = split_in_turns(builds(lambda u: probes._stream_launch(
            "t3", xs, ws, None, None, 20, upto=u, bf16_dots=bf16)),
            probes.STREAM_UPTO, 1e3 / (20 * probes.T3_DEPTH))
        for name, d in got.items():
            splits[f"T3 stream {mode} 1 chain {name}"] = d
        for n in (1, 4):
            for label, (xs, ws), kw, dots in (
                    ("T4 phase", t4.inputs(n, dev), (4, probes.T4_DEPTH, False, "clamp"),
                     4 * probes.T4_DEPTH),
                    ("T3 phase", t3.inputs(n, dev), (12, probes.T3_DEPTH, True, "renorm"),
                     12 * probes.T3_DEPTH)):
                got = split_in_turns(builds(lambda u, xs=xs, ws=ws, kw=kw: probes._phase_launch(
                    xs, ws, *kw, upto=u, bf16_dots=bf16)), probes.PHASE_UPTO, 1e3 / dots)
                for name, d in got.items():
                    splits[f"{label} {mode} {n} chain(s) {name}"] = d
    use("this")
    for key, d in splits.items():
        print(f"split, ns a dot (device time), {key}: "
              + ", ".join(f"{u} {v:.1f}" for u, v in d.items()))
    report["split_ns_per_dot"] = splits
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
