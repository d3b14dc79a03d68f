"""``ops/flows.py`` against the JAX package's ``vae_training_tpu.ops.flows``:
the six single-device tests of ``tests/test_flow_ops.py``, each also
holding the port's output to the JAX function's on the same numpy inputs
(bitwise where both are exact elementwise or layout ops; rtol 1e-6 where
float32 sums or a matrix inverse round in another order). The cross-device
moment mean (``process_group``, the JAX module's ``axis_name``) is held in
four gloo ranks by tests/test_torch_parallel_training.py, and on the card
with a one-rank NCCL group by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vae_training_tpu.ops import flows as jf  # noqa: E402
from vae_training_tpu_torch.ops import flows as tf  # noqa: E402


def test_leaky_relu_inverts():
    x = np.linspace(-3, 3, 31, dtype=np.float32)
    y = tf.leaky_relu(torch.as_tensor(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jf.leaky_relu(jnp.asarray(x))))
    back = tf.inv_leaky_relu(y)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jf.inv_leaky_relu(jnp.asarray(y))))
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-6)


def test_inv_dense():
    rs = np.random.RandomState(0)
    W, b, x = (rs.randn(*s).astype(np.float32) for s in ((4, 4), (4,), (8, 4)))
    y = x @ W + b
    got = tf.inv_dense(torch.as_tensor(y), torch.as_tensor(W), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, x, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jf.inv_dense(y, W, b)), rtol=1e-4, atol=1e-5)


def test_invertible_batch_norm_roundtrip():
    x = (np.random.RandomState(1).randn(64, 6) * 3.0 + 2.0).astype(np.float32)
    jbn = jf.InvertibleBatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), x)
    jy, mutated = jbn.apply(variables, x, mutable=["batch_stats"])
    bn = tf.InvertibleBatchNorm(6)
    y = bn(torch.as_tensor(x))
    # normalized output: ~zero mean, ~unit variance
    assert abs(float(y.detach().mean())) < 1e-5
    assert abs(float(y.detach().var(unbiased=False)) - 1.0) < 1e-2
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    stats = dict(bn.named_buffers())
    for k in ("mean", "var", "recent_mul", "recent_mean"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(mutated["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    x_rec = tf.inv_batch_norm(y, dict(bn.named_parameters()), stats)
    np.testing.assert_allclose(x_rec.detach().numpy(), x, rtol=1e-4, atol=1e-4)
    # running averages moved toward batch moments
    assert float(stats["mean"].abs().sum()) > 0
    # the running averages normalise in eval mode, as in the JAX module
    jy_eval = jbn.apply({**variables, "batch_stats": mutated["batch_stats"]}, x,
                        use_running_average=True, mutable=["batch_stats"])[0]
    np.testing.assert_allclose(bn(torch.as_tensor(x), use_running_average=True).detach().numpy(),
                               np.asarray(jy_eval), rtol=1e-5, atol=1e-6)


def test_get_mask_checkerboard_and_channel():
    for shape, reverse, board in (((4, 4, 2), False, True), ((4, 4, 2), True, True),
                                  ((4, 4, 4), False, False), ((4, 4, 4), True, False),
                                  ((1, 4, 4, 2), False, True), ((5, 3, 6), False, False)):
        got = tf.get_mask(shape, reverse, board)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jf.get_mask(shape, reverse, board)))
    m = tf.get_mask((4, 4, 2), reverse=False)
    assert m.shape == (4, 4, 1)
    np.testing.assert_array_equal(m[:2, :2, 0].numpy(), np.array([[0, 1], [1, 0]], np.float32))
    np.testing.assert_array_equal((m + tf.get_mask((4, 4, 2), reverse=True)).numpy(),
                                  np.ones((4, 4, 1), np.float32))
    assert tf.get_mask((1, 4, 4, 2), reverse=False).shape == (1, 4, 4, 1)


def test_squeeze_2x2_roundtrip():
    x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)
    s = tf.squeeze_2x2(torch.as_tensor(x))
    assert s.shape == (2, 4, 4, 12)
    np.testing.assert_array_equal(s.numpy(), np.asarray(jf.squeeze_2x2(jnp.asarray(x))))
    back = tf.squeeze_2x2(s, reverse=True)
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="divisible by 4"):
        tf.squeeze_2x2(torch.zeros((1, 4, 4, 3)), reverse=True)
    with pytest.raises(ValueError, match="even spatial"):
        tf.squeeze_2x2(torch.zeros((1, 5, 5, 3)))


def test_classifier_utils():
    logits = np.asarray([[1.0, 2.0, 3.0], [0.5, 0.1, 0.2]], np.float32)
    labels = np.asarray([2, 0])
    got = tf.cross_entropy_loss(torch.as_tensor(logits), torch.as_tensor(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.cross_entropy_loss(logits, labels)))
    np.testing.assert_allclose(got.numpy(), [-3.0, -0.5])
    acc = tf.compute_accuracy(torch.as_tensor(logits), torch.as_tensor(labels))
    assert float(acc) == float(jf.compute_accuracy(logits, labels)) == 1.0
