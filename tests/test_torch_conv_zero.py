"""Signed zeros through conv_layer's 2x2 pool, on the CPU.

JAX's max over a window takes +0 over -0 in either order, where
``torch.amax`` (and a max that keeps the first of two equal values) keeps
whichever came first. A conv output of the JAX path is -0 where one
channel's products are all -0 and XLA folds the +0 start of the sum away:
under ``jax.jit`` and in the Pallas kernel (interpret mode), not in eager
``conv_layer_ref``. The port's sums start at +0, as the eager reference's
do, so its conv outputs are never -0; its pool takes +0 over -0 all the
same. Bits are compared as integers.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.convlayer.kernel import conv_layer_pallas
from repro.kernels.convlayer.ref import conv_layer_ref as jax_conv_layer_ref
from repro_torch.kernels.convlayer.ref import conv_layer_ref, pool2x2

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def bits(t) -> np.ndarray:
    """Raw bits of a float array (jax, numpy or torch) as integers."""
    if isinstance(t, torch.Tensor):
        t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_pool_takes_plus_zero_over_minus_zero():
    """Every sign pattern of a window of zeros, and each beside a NaN: the
    port's pool gives JAX's ``.max`` over the same accumulator, bit for bit."""
    wins = list(itertools.product((0.0, -0.0), repeat=4))
    acc = np.array([[w[0], w[1]] for w in wins] + [[w[2], w[3]] for w in wins],
                   np.float32)                               # (2 * 16, 2)
    acc = acc.reshape(2, 16, 2).transpose(1, 0, 2).reshape(1, 32, 2)
    nan = acc.copy()
    nan[0, ::4, 1] = np.nan
    for a in (acc, nan):
        ref = jnp.asarray(a).reshape(1, 16, 2, 1, 2).max(axis=(2, 4))
        np.testing.assert_array_equal(bits(pool2x2(torch.from_numpy(a))),
                                      bits(ref))
    # +0 wherever the window holds one; -0 only in the all -0 window
    got = bits(pool2x2(torch.from_numpy(acc))).ravel()
    assert (got[:15] == 0).all() and np.signbit(np.int32(got[15]))


def zero_inputs(dt: torch.dtype):
    """x (1, 2, 6), f = -1 (1x1): conv outputs x * -1, i.e. -0 where x is
    +0 and +0 where x is -0. Windows: -0 then +0; -0, -0 then +0; all -0."""
    x = np.array([[[0.0, -0.0, 0.0, 0.0, 0.0, 0.0],
                   [0.0, 0.0, -0.0, -0.0, 0.0, 0.0]]], np.float32)
    f = -np.ones((1, 1, 1, 1), np.float32)
    return x, f


@pytest.mark.parametrize("dt", list(DTYPES))
def test_conv_signed_zero_windows_match_reference(dt):
    tdt = DTYPES[dt]
    x, f = zero_inputs(tdt)
    jx, jf = jnp.asarray(x, JNP[tdt]), jnp.asarray(f, JNP[tdt])
    eager = jax_conv_layer_ref(jx, jf)
    jit = jax.jit(jax_conv_layer_ref)(jx, jf)
    pallas = conv_layer_pallas(jx, jf, interpret=True)
    port = conv_layer_ref(torch.from_numpy(x).to(tdt), torch.from_numpy(f).to(tdt))
    assert port.shape == (1, 1, 3) and port.dtype == tdt
    # the windows that mix -0 and +0 conv outputs: +0 on every path
    for r in (eager, jit, pallas, port):
        np.testing.assert_array_equal(bits(r)[..., :2], 0)
    # the all -0 window: the port's sums start at +0, as eager's do
    np.testing.assert_array_equal(bits(port), bits(eager))
    # under jit and in the Pallas kernel the first product starts the sum
    for r in (jit, pallas):
        assert np.signbit(np.asarray(r, np.float32)[0, 0, 2])
