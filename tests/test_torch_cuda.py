"""K1 on the card: the CUDA kernel against its plain PyTorch version.

These tests need a CUDA device of compute capability 9.0 and nvcc; they
carry the ``cuda`` marker and skip elsewhere. The file imports no JAX, so on
a machine without it run them with the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are those of tests/test_pallas_kernel.py: both sides are fp32,
and only summation order and libm ulps differ.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu_torch.data import LinearGaussianDataset  # noqa: E402
from vae_training_tpu_torch.kernels import linear_vae as k1  # noqa: E402
from vae_training_tpu_torch.models import build_vae  # noqa: E402
from vae_training_tpu_torch.ops import rng  # noqa: E402
from vae_training_tpu_torch.train import TrainState  # noqa: E402

D, L, ID, B = 12, 20, 3, 100


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if torch.cuda.get_device_capability() != k1.CAPABILITY:
        pytest.skip("needs an sm_90 device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flat_state(device, tdv):
    model = build_vae(data_dim=D, latent_dim=L, epsilon=-1.0, tunable_decoder_var=tdv)
    model.init_parameters(0)
    state = TrainState.create(dict(model.named_parameters()), 1, 2).to(device)
    return k1.pack_state(state, D, L)


def _chunk(p, m, v, a, n, step0, tdv, noise=None, plain=False):
    fn = k1.plain_fused_chunk if plain else k1.run_fused_chunk
    return fn(p, m, v, a, n_steps=n, batch=B, data_dim=D, latent_dim=L,
              intrinsic_dim=ID, manifold_dim=ID, step0=step0, t0=step0,
              data_seed=rng.derive_seed(2, 1), model_seed=rng.derive_seed(0, 3),
              var_added=0.0, eps_const=-1.0, tdv=tdv, lr=1e-3, external_noise=noise)


@pytest.mark.cuda
@pytest.mark.parametrize("external", [True, False])
@pytest.mark.parametrize("tdv", [True, False])
def test_kernel_matches_plain(cuda_device, tdv, external):
    ds = LinearGaussianDataset.create(2, 3, 3, 9, device=cuda_device)
    n = 32
    noise = None
    if external:
        rs = np.random.RandomState(0)
        xs = np.zeros((n, B, D), np.float32)
        xs[:, :, :3] = rs.randn(n, B, 3).astype(np.float32) @ ds.A.cpu().numpy().T
        noise = tuple(torch.as_tensor(a, device=cuda_device) for a in (
            xs, rs.randn(n, B, L).astype(np.float32), rs.randn(n, B, D).astype(np.float32)))
    kp, km, kv = _flat_state(cuda_device, tdv)
    pp, pm, pv = (t.clone() for t in (kp, km, kv))
    kl = _chunk(kp, km, kv, ds.A, n, 0, tdv, noise)
    pl = _chunk(pp, pm, pv, ds.A, n, 0, tdv, noise, plain=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(kl.cpu(), pl.cpu(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(kp.cpu(), pp.cpu(), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(km.cpu(), pm.cpu(), rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(kv.cpu(), pv.cpu(), rtol=5e-4, atol=1e-7)


@pytest.mark.cuda
def test_kernel_is_chunk_independent(cuda_device):
    """One 40-step launch equals a 15 + 25 split bitwise (resume relies on it)."""
    ds = LinearGaussianDataset.create(2, 3, 3, 9, device=cuda_device)
    a = _flat_state(cuda_device, True)
    b = tuple(t.clone() for t in a)
    la = _chunk(*a, ds.A, 40, 0, True)
    lb = torch.cat([_chunk(*b, ds.A, 15, 0, True), _chunk(*b, ds.A, 25, 15, True)])
    torch.cuda.synchronize()
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_sampler_words_are_bitwise(cuda_device):
    for seed, step, stream in ((0, 0, 0), (2**64 - 1, 123456, 3), (98765, 7, 1)):
        words, normals = k1.sampler_check(100, 6, step, stream, seed, cuda_device)
        ref = rng.words(seed, step, 100, stream, 6)
        assert torch.equal(words.cpu(), ref)
        np.testing.assert_allclose(normals.cpu(), rng.box_muller(ref), rtol=0, atol=1e-5)
    assert k1.kernel_smem_bytes(B, D, L, ID, ID) == k1.smem_bytes(B, D, L, ID, ID)
