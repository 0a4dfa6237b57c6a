"""The port's gelu against ``jax.nn.gelu(approximate=True)``, on the CPU.

Input: 65,536 values of 3 N(0, 1), numpy seed 0, cast to bf16.  The port's
``layers.gelu`` follows JAX's op graph, each op rounding in bf16 with its
constants rounded to bf16 first, and equals XLA:CPU's result bit for bit.
A fused ``F.gelu(approximate="tanh")``, which rounds once, fails the same
check: that was the port's MLP before, and the test guards against it.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.model import layers  # noqa: E402

X = (3 * np.random.default_rng(0).standard_normal(65536)).astype(np.float32)


def _jax_gelu(dtype):
    x = jnp.asarray(X).astype(dtype)
    return np.asarray(jax.nn.gelu(x, approximate=True).astype(jnp.float32))


def _bits_differ(fn):
    got = fn(torch.from_numpy(X).to(torch.bfloat16)).float().numpy()
    want = _jax_gelu(jnp.bfloat16)
    return int((got != want).sum()), float(np.abs(got - want).max())


def test_gelu_equals_jax_bit_for_bit_in_bf16():
    assert _bits_differ(layers.gelu) == (0, 0.0)


def test_fused_gelu_fails_the_same_check():
    n, err = _bits_differ(lambda a: F.gelu(a, approximate="tanh"))
    assert n == 28014 and err == 2 ** -6


def test_gelu_in_f32_matches_jax():
    """In f32 the two agree to an ulp or two, but for the negative x where
    tanh's argument falls below about -5 (x < -3.8): PyTorch's vectorized
    f32 tanh may give -1 there, depending on where the thread's chunk
    starts, so 1 + tanh and the output are 0 in place of JAX's gelu(x),
    which is at most 1.8e-4 in size there.  Hence atol 2e-4."""
    got = layers.gelu(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, _jax_gelu(jnp.float32), rtol=1e-6,
                               atol=2e-4)
