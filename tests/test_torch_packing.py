"""The port's 2-bit codec writes the JAX package's bytes and inverts them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.core import packing as jpack
from pt2tpu_torch.core import packing as tpack


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_pack_bytes_identical(bs):
    rng = np.random.default_rng(bs)
    T = rng.integers(-1, 2, size=(96, 4 * bs)).astype(np.int8)
    want = np.asarray(jpack.pack_ternary(jnp.asarray(T), block_size=bs))
    got = tpack.pack_ternary(torch.from_numpy(T), block_size=bs).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_unpack_round_trip(bs):
    rng = np.random.default_rng(100 + bs)
    T = rng.integers(-1, 2, size=(64, 3 * bs)).astype(np.int8)
    packed = tpack.pack_ternary(torch.from_numpy(T), block_size=bs)
    back = tpack.unpack_ternary(packed, block_size=bs).numpy()
    np.testing.assert_array_equal(back, T.T)
    # and the JAX unpack of the port's bytes agrees
    np.testing.assert_array_equal(
        np.asarray(jpack.unpack_ternary(jnp.asarray(packed.numpy()), block_size=bs)), T.T
    )


def test_unpack_high_plane_is_masked():
    """Bytes with the top bit set (plane 3 = code +1 -> u = 2, i.e. 0b10xxxxxx)
    are negative as int8; the unpack must not smear the sign."""
    T = np.ones((4, 128), np.int8)  # every byte 0b10101010 = -86 as int8
    packed = tpack.pack_ternary(torch.from_numpy(T), block_size=128)
    assert int(packed.min()) < 0
    np.testing.assert_array_equal(tpack.unpack_ternary(packed, 128).numpy(), T.T)


def test_pack_rejects_bad_block():
    with pytest.raises(ValueError):
        tpack.pack_ternary(torch.zeros((4, 100), dtype=torch.int8), block_size=64)
