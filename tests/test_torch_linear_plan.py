"""The linear kernel's host-side plan (K1, K2, K6a; ``csrc/linear_vae.cu``).

The kernel runs on the card only; what these CPU tests hold is the
arithmetic the host and the kernel share: the shared-memory plan
(``kernels/linear_vae.py:smem_bytes`` mirrors ``plan`` in the .cu file,
buffer by buffer) at every row of the reference's linear and sigmoid
sweeps, the CTA's split into row warps and noise warps, and the
per-parameter pass's tiles (a Python transcription of ``param_pass``'s
numbering): every trained slot of the flat layout is covered by exactly one
tile output, the bias rows are the slots ``matrix_mask`` keeps in f32, and
the loss lane's ε is the one slot left. The card tests
(tests/test_torch_cuda.py) hold the library's own figures to these.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch._scripts.sweep import LINEAR_GRID, SIGMOID_GRID  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402

SOURCE = (Path(k1.__file__).resolve().parent.parent / "csrc" / "linear_vae.cu").read_text()
B = 100  # every sweep's batch
# (D, L, intrinsic, manifold, dual) of every sweep row's shape
SHAPES = ([(dd + pd, ld, dd, dd, False) for dd, pd, ld in LINEAR_GRID]
          + [(dd + 1 + pd, ld, dd, dd, True) for dd, pd, ld in SIGMOID_GRID])
IDS = [f"{'sigmoid' if s[4] else 'linear'}-D{s[0]}-L{s[1]}" for s in SHAPES]


def _constant(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, name
    return m.group(1)


def test_the_cta_split_matches_the_source():
    threads, row_warps, group, team = (
        int(_constant(n)) for n in ("kThreads", "kRowWarps", "kGroup", "kTeam"))
    assert threads == k1.THREADS == 1024
    # the sweeps' batch of 100 rows takes one round of the per-row pass and
    # no more warps than that round needs; the warps left draw the next
    # step's noise
    assert row_warps * 32 // group >= B > (row_warps - 1) * 32 // group
    assert row_warps < threads // 32
    assert team == 8  # a lane of a team updates two of a 4×4 tile's 16 outputs
    for name, value in k1.SKIP.items():
        assert int(_constant(f"kSkip{name.capitalize()}")) == value


def test_smem_bytes_at_linear_row_1_by_hand():
    # the header 128; P = 2·12·20 + 2·20 + 12 + 1 = 533 → 536 a copy, three
    # copies; A 3×3 → 12; e^{ep/2} 20; 4 scalars; 1 − βᵗ of 256 steps 512;
    # the weights' copies WeT 20 × 20, Wd 20 × 12, WdT 12 × 28 (strides odd
    # multiples of 4: D+1 = 13 → 20, D = 12 → 12, L+1 = 21 → 28); x (20 a
    # row), z1, z2 twice: 2·(2000 + 2000 + 1200); n 300; s 2800; g_y 1200;
    # g_mu, g_s·z1 2000 each; the partial sums 300
    floats = (128 + 3 * 536 + 12 + 20 + 4 + 512 + 400 + 240 + 336 + 2 * 5200 + 300
              + 2800 + 1200 + 2 * 2000 + 300)
    assert k1.smem_bytes(B, 12, 20, 3, 3) == 4 * floats == 89040
    for name, value in (("kHeader", k1.HEADER), ("kBcSteps", k1.BC_STEPS)):
        assert int(_constant(name)) == value


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_sweep_row_fits_one_block(shape):
    D, L, id_, dd, dual = shape
    need = k1.smem_bytes(B, D, L, id_, dd, dual)
    assert need <= k1.SMEM_LIMIT
    # the two noise buffers are a real part of it: one step's x, z1 and z2
    noise = 4 * B * ((D + 1 + (D + 1) % 2) + L + D)
    assert need > 2 * noise


def test_the_largest_row_is_the_sigmoid_sweeps_last():
    need = {s: k1.smem_bytes(B, *s[:4], s[4]) for s in SHAPES}
    assert max(need, key=need.get) == (28, 24, 7, 7, True)
    assert need[(28, 24, 7, 7, True)] == 170496  # 73% of a block's 232,448 B


def _tiles(D, L, dual):
    """param_pass's tiles in the kernel's order: for each, the (flat index,
    bf16-eligible) of the outputs its lanes update (lane t of 8: column t % 4,
    rows 2·(t // 4) and 2·(t // 4) + 1)."""
    blocks = [(D + 1, L, 0)]  # [We; be]
    o_wd = D * L + L
    blocks.append((L + 1, D, o_wd))  # [Wd; bd]
    if dual:
        blocks.append((L + 1, D, o_wd + L * D + D + L + 1))  # [Ws; bs]
    tiles = []
    for R, C, off in blocks:
        tc = (C + 3) // 4
        for i in range(((R + 3) // 4) * tc):
            r0, c0 = 4 * (i // tc), 4 * (i % tc)
            tiles.append([(off + r * C + c, r < R - 1) for t in range(8) for h in range(2)
                          for r, c in [(r0 + 2 * (t // 4) + h, c0 + t % 4)] if r < R and c < C])
    o_ep = o_wd + L * D + D
    for c0 in range(0, L, 4):
        tiles.append([(o_ep + c0 + t, False) for t in range(4) if c0 + t < L])
    return tiles


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_the_tiles_cover_every_parameter_once(shape):
    D, L, _, _, dual = shape
    tiles = _tiles(D, L, dual)
    n_tiles = ((D + 4) // 4) * ((L + 3) // 4) + ((L + 4) // 4) * ((D + 3) // 4) * (2 if dual else 1)
    assert len(tiles) == n_tiles + (L + 3) // 4  # the kernel's count
    slots = [i for tile in tiles for i, _ in tile]
    layout = k1.param_layout(D, L, dual)
    o_eps = k1.n_params(D, L) - 1
    assert sorted(slots) == [i for i in range(k1.n_params(D, L, dual)) if i != o_eps]
    # the kernel's bf16 rule (a tile output off its block's last row) is
    # matrix_mask's (the weight matrices, not the biases or ep)
    mask = k1.matrix_mask(layout)
    for i, bf16 in (x for tile in tiles for x in tile):
        assert bool(mask[i]) == bf16, i
    assert not bool(mask[o_eps])


def test_grid_launch_refuses_a_skip_out_of_range():
    p = torch.zeros(k1.n_params(12, 20))
    row = k1.GridRow(12, 20, 3, 3, torch.zeros(3, 3), 0, 0, 1, 2)
    for skip in (-1, sum(k1.SKIP.values()) + 1):
        with pytest.raises(ValueError, match="skip"):
            k1._grid_launch(p, p.clone(), p.clone(), [row], n_steps=1, batch=B, eps_const=-1.0,
                            tdv=True, lr=1e-3, skip=skip)
