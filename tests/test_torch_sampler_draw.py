"""T1's draw (csrc/linear_vae.cu philox_draw_kernel) on the CPU.

``kernels/linear_vae.py:sampler_normals`` (normals only) and
``sampler_check`` (words and normals) run their plain version,
``ops/rng.py``, on a CPU device: the normals must be
``rng.box_muller(rng.words(...))`` bitwise, and the words ``rng.words``'s
bits as int32, at shapes whose calls are no multiple of a block. Both
refuse shapes the kernel does not take. ``_grid`` and ``_cover`` mirror
the kernel's launch geometry (csrc/linear_vae.cu ``draw_grid`` and the
walk of ``philox_draw_kernel``: call i = row·n_draws + draw, the grid's
stride, (row, draw) stepped by an add and a compare): every (row, draw) is
written once, on grids that fill the card and on small ones where a thread
makes many calls. T1's battery draws through ``sampler_normals``. The
kernel itself is held bitwise to the words entry and ``ops/rng.py`` on the
card, into uninitialised outputs (tests/test_torch_cuda.py, chip_smoke.py
phases 3 and 30).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.ops import rng  # noqa: E402
from vae_training_tpu_torch.tools import check_kernel_rng as t1  # noqa: E402

ODD = [(1, 1), (37, 5), (257, 3), (100, 6), (3, 341)]


@pytest.mark.parametrize("rows, n_draws", ODD, ids=lambda v: str(v))
def test_normals_on_the_cpu_are_the_plain_version_bitwise(rows, n_draws):
    for seed, step, stream in ((0, 0, 0), (2**64 - 1, 4_000_000_000, 3), (98765, 7, 1)):
        got = k1.sampler_normals(rows, n_draws, step, stream, seed, "cpu")
        want = rng.box_muller(rng.words(seed, step, rows, stream, n_draws))
        assert got.shape == (rows, n_draws, 4) and got.dtype == torch.float32
        assert torch.equal(got, want)


@pytest.mark.parametrize("rows, n_draws", ODD, ids=lambda v: str(v))
def test_words_entry_on_the_cpu(rows, n_draws):
    words, normals = k1.sampler_check(rows, n_draws, 11, 2, 12345, torch.device("cpu"))
    ref = rng.words(12345, 11, rows, 2, n_draws)
    assert words.dtype == torch.int32 and torch.equal(rng.widen(words), ref)
    assert torch.equal(normals, k1.sampler_normals(rows, n_draws, 11, 2, 12345, "cpu"))


def test_widen_and_narrow_keep_the_bits():
    w = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    n = rng.narrow(w)
    assert n.dtype == torch.int32 and n.tolist() == [0, 1, 2**31 - 1, -2**31, -1]
    assert torch.equal(rng.widen(n), w)


@pytest.mark.parametrize("fn", [k1.sampler_normals, k1.sampler_check],
                         ids=["normals", "words"])
@pytest.mark.parametrize("rows, n_draws", [(0, 5), (5, 0), (-1, 3), (2**20, 2**12)])
def test_draw_refuses_bad_shapes(fn, rows, n_draws):
    with pytest.raises(ValueError, match="rows and n_draws"):
        fn(rows, n_draws, 0, 0, 0, "cpu")


def test_draw_refuses_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k1.sampler_normals(2, 2, 0, 0, 0, "meta")


THREADS = 256  # csrc/linear_vae.cu kSamplerThreads


def _grid(rows, n_draws, sms, per_sm):
    """draw_grid: every SM filled with the blocks it holds, or fewer when
    the calls run out."""
    return min(-(-rows * n_draws // THREADS), sms * per_sm)


def _cover(rows, n_draws, blocks, threads=THREADS):
    """How often a launch of ``blocks`` × ``threads`` writes each (row,
    draw), counted at the (row, draw) the kernel steps to without division."""
    n, stride = rows * n_draws, blocks * threads
    i = np.arange(min(stride, n), dtype=np.int64)
    r, j = i // n_draws, i % n_draws
    sr, sj = divmod(stride, n_draws)
    count = np.zeros((rows, n_draws), np.int64)
    while i.size:
        np.add.at(count, (r, j), 1)
        i, r, j = i + stride, r + sr, j + sj
        wrap = j >= n_draws
        j, r = np.where(wrap, j - n_draws, j), np.where(wrap, r + 1, r)
        live = i < n
        i, r, j = i[live], r[live], j[live]
    return count


def test_grid_fills_the_card_or_the_calls():
    assert _grid(16384, 32, 132, 8) == 132 * 8  # T1's draw: ~2 calls a thread
    assert _grid(37, 5, 132, 8) == 1
    assert _grid(1000, 3, 132, 6) == 12


@pytest.mark.parametrize("rows, n_draws", [(37, 5), (3, 341), (16384, 32)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("blocks, threads", [(1, 32), (7, 256), (132 * 8, 256)])
def test_launch_walk_covers_every_draw_once(rows, n_draws, blocks, threads):
    """A small grid (many calls a thread), a middling one and the H100's
    (132 SMs of 8 blocks: about two calls a thread at T1's shape)."""
    cover = _cover(rows, n_draws, blocks, threads)
    assert cover.shape == (rows, n_draws) and np.all(cover == 1)


def test_battery_draws_through_the_normals_only_entry():
    """T1's card draw is sampler_normals (on the CPU, its plain version):
    the same normals as the battery's plain draw, bitwise."""
    draw = t1.card_draw(torch.device("cpu"))
    assert torch.equal(draw(2468, 7, 33, rng.STREAM_Z2, t1.N_DRAWS),
                       t1.plain_draw(2468, 7, 33, rng.STREAM_Z2, t1.N_DRAWS))
