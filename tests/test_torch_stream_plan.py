"""T3's and T5's stream form (csrc/probes.cu chain_stream_kernel) planned on the CPU.

``kernels/probes.py`` keeps the kernel's index arithmetic in three
functions the kernel's wrapper sits beside: ``stream_cta`` (which CTA
computes which tile of h, which K chunks each warp's ring stages hold,
which rows of W a CTA's Adam updates, where its column sums and its max|y|
go), ``stream_weight`` (the weight a dot reads) and ``stream_schedule``
(one CTA's program: the copies, the dots, T3's renorm, T5's Adam and the
cluster barriers, in the kernel's order). Checked here:

  - the partition: every output of h owned once, each warp's stages cover
    its K slice once in K order, the 16 CTAs' Adam bands cover each buffer
    once, the column sums reach exactly the CTAs of the column slice;
  - the schedule: every dot's chunks are copied once, after the previous
    dot has read the stages and before the dot; every copy of a buffer
    Adam has rewritten comes after that Adam, a cluster arrive and a
    cluster wait (the tail's first dot of a step waits for them); a
    schedule that copies the tail's next dot before Adam fails the check;
  - a plain numpy emulation of the kernel driven by that schedule (each
    CTA's own two buffers of its rows of h, each warp's ring snapshot of W
    taken when its copy is issued, the products stage by stage in float32,
    the 8 partials summed in K order, the rows pushed to the peer, T3's 16
    maxima met, T5's column sums summed in row-group order) against the
    JAX tools' Pallas bodies in interpret mode (the tools loaded by file
    path) and the port's plain versions: T3 at 1, 2 and 4 chains, 2 trips,
    rtol 1e-4 / atol 1e-5 (256-term sums in another order); T5 in both
    modes on ``check_inputs``, 2 steps, h at the MLP kernel's params
    tolerance and what Adam changed in w, m and v within ``DELTA_RTOL``,
    with its two controls (the state left as it was; the other mode). An
    emulation that pushes no rows, keeps each CTA's own max or sums only
    its own rows fails those comparisons.

Inputs come from numpy seeds.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")

from vae_training_tpu_torch.kernels import probes  # noqa: E402
from vae_training_tpu_torch.tools import probe_adam_overlap as t5  # noqa: E402
from vae_training_tpu_torch.tools import probe_mxu_pipelining as t3  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_TOL = {"params": (1e-3, 1e-5)}
CHAINS = (1, 2, 4)
MODES = ("t3", "tail", "interleaved")
f32 = np.float32


def load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctas(n_chains):
    return [probes.stream_cta(n_chains, b) for b in range(n_chains * probes.CHAIN_CLUSTER)]


# --- the partition -----------------------------------------------------------

@pytest.mark.parametrize("n_chains", CHAINS)
def test_partition_owns_every_output_once(n_chains):
    own = np.zeros((n_chains, probes.ROWS, probes.W), np.int64)
    for cta in _ctas(n_chains):
        (r0, r1), (c0, c1) = cta["rows"], cta["cols"]
        own[cta["chain"], r0:r1, c0:c1] += 1
        # each warp's stages: its K slice once, in K order, 8 k-rows a stage
        for (k0, k1), stages in zip(cta["k_slices"], cta["stages"]):
            assert len(stages) == probes.STREAM_STAGES
            assert stages[0][0] == k0 and stages[-1][1] == k1
            assert all(b - a == probes.STREAM_CHUNK_K for a, b in stages)
            assert all(stages[i][1] == stages[i + 1][0] for i in range(len(stages) - 1))
        cover = np.zeros(probes.W, np.int64)
        for stages in cta["stages"]:
            for a, b in stages:
                cover[a:b] += 1
        assert np.all(cover == 1)
    assert np.all(own == 1)


@pytest.mark.parametrize("n_chains", CHAINS)
def test_partition_adam_bands_and_exchanges(n_chains):
    ctas = _ctas(n_chains)
    for chain in range(n_chains):
        mine = [c for c in ctas if c["chain"] == chain]
        band = np.zeros((probes.W, probes.W), np.int64)
        for cta in mine:
            (a0, a1), (c0, c1) = cta["adam_rows"], cta["cols"]
            band[a0:a1, c0:c1] += 1
            same_slice = sorted(o["rank"] for o in mine if o["cols"] == cta["cols"])
            assert sorted(cta["sum_ranks"]) == same_slice and len(same_slice) == 8
            # the sums' senders cover the 104 rows once
            rows = np.zeros(probes.ROWS, np.int64)
            for o in mine:
                if cta["rank"] in o["sum_ranks"]:
                    rows[o["rows"][0]:o["rows"][1]] += 1
            assert np.all(rows == 1)
            assert cta["max_ranks"] == list(range(probes.CHAIN_CLUSTER))
        assert np.all(band == 1)


def test_weights_a_dot_follow_the_tools():
    """T3: chain c's dot d of every trip reads its weight d (the stack's
    rows d·W..); T5: dots 5b..5b + 4 of every step read buffer b."""
    for chain in range(4):
        assert [probes.stream_weight("t3", chain, g) for g in range(16)] == \
            [chain * 8 + g % 8 for g in range(16)]
    for mode in ("tail", "interleaved"):
        assert [probes.stream_weight(mode, 0, g) for g in range(50)] == \
            [(g % 25) // 5 for g in range(50)]


# --- the schedule ------------------------------------------------------------

def schedule_faults(mode, events):
    """The schedule's ordering rules, broken ones listed."""
    faults = []
    where = {e: i for i, e in enumerate(events) if e[0] in ("issue", "dot")}
    dots = sorted(e[1] for e in events if e[0] == "dot")
    for g in dots:
        issues = [i for i, e in enumerate(events) if e == ("issue", g)]
        if len(issues) != 1:
            faults.append(f"dot {g}: {len(issues)} copies")
            continue
        at = issues[0]
        if at > where[("dot", g)]:
            faults.append(f"dot {g}: copied after it ran")
        if g and at < where[("dot", g - 1)]:
            faults.append(f"dot {g}: copied before dot {g - 1} read the stages")
        if mode == "t3":
            continue
        # the last Adam on this dot's buffer before the dot, in program order
        b = probes.stream_weight(mode, 0, g)
        adams = [i for i, e in enumerate(events[:where[("dot", g)]])
                 if e[0] == "adam" and e[1] == b]
        if not adams:
            continue
        a = adams[-1]
        between = [e[0] for e in events[a:at]]
        if at < a or "arrive" not in between or \
                "wait" not in between[between.index("arrive"):]:
            faults.append(f"dot {g}: buffer {b} copied before Adam's release and acquire")
    return faults


@pytest.mark.parametrize("mode", MODES)
def test_schedule_orders_copies_after_adam(mode):
    events = probes.stream_schedule(mode, 3)
    assert schedule_faults(mode, events) == []
    depth = probes._stream_depth(mode)
    assert [e[1] for e in events if e[0] == "dot"] == list(range(3 * depth))
    kinds = [e[0] for e in events]
    assert kinds.count("arrive") == kinds.count("wait")
    if mode == "t3":
        assert [e for e in events if e[0] == "renorm"] == [("renorm", t) for t in range(3)]
        for t in range(3):  # after the trip's last dot, before the next trip's first
            at = events.index(("renorm", t))
            assert events.index(("dot", 8 * t + 7)) < at
            assert t == 2 or at < events.index(("dot", 8 * t + 8))
    else:
        adams = [e[1:] for e in events if e[0] == "adam"]
        assert sorted(adams) == sorted((b, s) for b in range(5) for s in range(3))


def test_schedule_check_fails_a_tail_copy_before_adam():
    """The control: the tail's next step's first copy issued as dot 24 runs
    (as T3's are) reads buffer 0 before Adam rewrote it."""
    events = probes.stream_schedule("tail", 2)
    early = [e for e in events if e != ("issue", 25)]
    early.insert(early.index(("dot", 24)) + 1, ("issue", 25))
    assert schedule_faults("tail", early) == ["dot 25: buffer 0 copied before Adam's "
                                              "release and acquire"]


# --- the emulation -----------------------------------------------------------

def emulate(mode, x, w, m=None, v=None, n_steps=2, t0=0, push=True, share=True):
    """The kernel's arithmetic in plain numpy, CTA by CTA, event by event
    of ``stream_schedule``. ``push`` False drops the rows sent to the peer;
    ``share`` False keeps each CTA's own max|y| (T3) or its own rows'
    column sums (T5). Returns the final h; w, m and v are updated in
    place."""
    x = np.asarray(x, f32)
    n_chains = x.shape[0]
    ctas = _ctas(n_chains)
    stack = w.reshape(-1, probes.W, probes.W)  # views: Adam writes through
    rows = probes.ROWS // 8
    h = {c["chain"] * 16 + c["rank"]: np.zeros((2, rows, probes.W), f32) for c in ctas}
    ring = {}
    for c in ctas:
        h[c["chain"] * 16 + c["rank"]][0] = x[c["chain"], c["rows"][0]:c["rows"][1]]
    key = lambda c: c["chain"] * 16 + c["rank"]  # noqa: E731
    cur = 0
    for ev in probes.stream_schedule(mode, n_steps):
        if ev[0] == "issue":
            for c in ctas:
                wd = stack[probes.stream_weight(mode, c["chain"], ev[1])]
                c0, c1 = c["cols"]
                ring[key(c)] = [[wd[a:b, c0:c1].copy() for a, b in st] for st in c["stages"]]
        elif ev[0] == "dot":
            new = {}
            for c in ctas:
                hc = h[key(c)][cur]
                parts = []
                for stages, chunks in zip(c["stages"], ring[key(c)]):
                    acc = np.zeros((rows, 128), f32)
                    for (a, b), wc in zip(stages, chunks):
                        acc = (acc + hc[:, a:b] @ wc).astype(f32)
                    parts.append(acc)
                s = parts[0]
                for p in parts[1:]:
                    s = (s + p).astype(f32)
                new[key(c)] = s if mode == "t3" else np.minimum(s, f32(probes.CLAMP))
            cur ^= 1
            for c in ctas:
                c0, c1 = c["cols"]
                for r in [c["rank"]] + (c["peers"] if push else []):
                    h[c["chain"] * 16 + r][cur][:, c0:c1] = new[key(c)]
        elif ev[0] == "renorm":
            tops = {key(c): np.abs(h[key(c)][cur][:, c["cols"][0]:c["cols"][1]]).max()
                    for c in ctas}
            for c in ctas:
                mx = max(tops[c["chain"] * 16 + r] for r in c["max_ranks"]) if share \
                    else tops[key(c)]
                h[key(c)][cur] = h[key(c)][cur] * (f32(1.0) / max(f32(mx), f32(1e-6)))
        elif ev[0] == "adam":
            b, step = ev[1], ev[2]
            sums = {}
            for c in ctas:
                hc = h[key(c)][cur][:, c["cols"][0]:c["cols"][1]]
                s = hc[0].copy()
                for r in range(1, rows):
                    s = (s + hc[r]).astype(f32)
                sums[key(c)] = s
            tt = t0 + step + 1
            bc1, bc2 = f32(1.0 - 0.9 ** tt), f32(1.0 - 0.999 ** tt)
            bc2s = np.sqrt(bc2)
            lr_t = f32(probes.ADAM_LR) * bc2s / bc1
            for c in ctas:
                senders = sorted(c["sum_ranks"]) if share else [c["rank"]]
                s = sums[senders[0]]
                for r in senders[1:]:
                    s = (s + sums[r]).astype(f32)
                g = (s / f32(probes.ROWS)) * f32(1e-6 * (b + 1))
                (a0, a1), (c0, c1) = c["adam_rows"], c["cols"]
                mb, vb, wb = m[b, a0:a1, c0:c1], v[b, a0:a1, c0:c1], stack[b, a0:a1, c0:c1]
                mn = f32(probes.B1) * mb + f32(1.0 - probes.B1) * g
                vn = f32(probes.B2) * vb + f32(1.0 - probes.B2) * g * g
                mb[...], vb[...] = mn, vn
                wb[...] = wb - lr_t * mn / (np.sqrt(vn) + f32(probes.EPS) * bc2s)
    out = np.full_like(x, np.nan)
    for c in ctas:
        (r0, r1), (c0, c1) = c["rows"], c["cols"]
        out[c["chain"], r0:r1, c0:c1] = h[key(c)][cur][:, c0:c1]
    return out


def _t3_tool(xs, ws, n_trips):
    tool = load_tool("probe_mxu_pipelining")
    tool.STEPS = n_trips
    n = xs.shape[0]
    out = pl.pallas_call(tool.make_kernel(n),
                         out_shape=[jax.ShapeDtypeStruct((probes.ROWS, probes.W), jnp.float32)] * n,
                         interpret=True)(*map(jnp.asarray, xs.numpy()), *map(jnp.asarray, ws.numpy()))
    return np.stack([np.asarray(o) for o in out])


@pytest.mark.parametrize("n_chains", CHAINS)
def test_t3_emulation_matches_plain_and_the_tool(n_chains):
    xs, ws = t3.inputs(n_chains, "cpu")
    got = emulate("t3", xs.numpy(), ws.numpy().copy(), n_steps=2)
    assert np.all(np.isfinite(got))
    tol = dict(rtol=1e-4, atol=1e-5)
    want = probes.plain_chain_chunk(xs, ws, n_steps=2, depth=probes.T3_DEPTH,
                                    weights_per_depth=True, epilogue="renorm").numpy()
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, _t3_tool(xs, ws, 2), **tol)


@pytest.mark.parametrize("control", ["push", "share"])
def test_t3_emulation_needs_its_exchanges(control):
    xs, ws = t3.inputs(2, "cpu")
    want = probes.plain_chain_chunk(xs, ws, n_steps=2, depth=probes.T3_DEPTH,
                                    weights_per_depth=True, epilogue="renorm").numpy()
    got = emulate("t3", xs.numpy(), ws.numpy().copy(), n_steps=2, **{control: False})
    assert not np.allclose(got, want, rtol=1e-4, atol=1e-5)


def _t5_tool(x, ws, ms, vs, interleave, n_steps=2):
    tool = load_tool("probe_adam_overlap")
    f = lambda s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    jin = [jnp.asarray(a) for a in (x.numpy(), *ws.numpy(), *ms.numpy(), *vs.numpy())]
    out = [np.array(a) for a in pl.pallas_call(
        tool._kernel(n_steps, interleave),
        out_shape=[f((probes.ROWS, probes.W))] + [f((probes.W, probes.W))] * 15,
        interpret=True)(*jin)]
    return out[0], [np.stack(out[1 + 5 * k:6 + 5 * k]) for k in range(3)]


@pytest.fixture(scope="module")
def t5_tool_runs():
    x, ws, ms, vs = t5.check_inputs("cpu")
    return {il: _t5_tool(x, ws, ms, vs, il) for il in (False, True)}


def _t5_emulate(interleave, **kw):
    x, ws, ms, vs = (t.numpy().copy() for t in t5.check_inputs("cpu"))
    h = emulate("interleaved" if interleave else "tail", x[None], ws, ms, vs, n_steps=2, **kw)
    return h[0], (ws, ms, vs)


@pytest.mark.parametrize("interleave", [False, True], ids=["tail", "interleaved"])
def test_t5_emulation_matches_the_tool_and_plain(t5_tool_runs, interleave):
    start = [t.numpy() for t in t5.check_inputs("cpu")[1:]]
    h, state = _t5_emulate(interleave)
    want_h, want_state = t5_tool_runs[interleave]
    np.testing.assert_allclose(h, want_h, *MLP_TOL["params"])
    kb = t5.check_inputs("cpu")
    plain_h = probes.plain_adam_overlap_chunk(*kb, n_steps=2, interleave=interleave).numpy()
    np.testing.assert_allclose(h, plain_h, *MLP_TOL["params"])
    _, other = t5_tool_runs[not interleave]
    as_t = torch.as_tensor
    for name, got, ref, plain, s0, o in zip("wmv", state, want_state, kb[1:], start, other):
        for r in (ref, plain.numpy()):
            assert t5.delta_mismatch(as_t(got), as_t(r), as_t(s0)) <= t5.DELTA_RTOL, name
        assert t5.delta_mismatch(as_t(s0), as_t(ref), as_t(s0)) > 100 * t5.DELTA_RTOL, name
        assert t5.delta_mismatch(as_t(o), as_t(ref), as_t(s0)) > 10 * t5.DELTA_RTOL, name


@pytest.mark.parametrize("interleave", [False, True], ids=["tail", "interleaved"])
def test_t5_emulation_needs_the_slices_sums(t5_tool_runs, interleave):
    """Each CTA's Adam from its own 13 rows' sums alone: the change in m
    misses the tool's."""
    start = t5.check_inputs("cpu")
    _, (_, ms, _) = _t5_emulate(interleave, share=False)
    ref = t5_tool_runs[interleave][1][1]
    assert t5.delta_mismatch(torch.as_tensor(ms), torch.as_tensor(ref), start[2]) > \
        10 * t5.DELTA_RTOL
