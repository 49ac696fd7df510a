"""ops/common.decimate == numpy stride slicing, cropped to full windows."""
import jax.numpy as jnp
import numpy as np
import pytest

from instancefusion_tpu.ops.common import decimate

_RNG = np.random.RandomState(7)
_CASES = [
    (_RNG.rand(48, 64).astype(np.float32), 2),
    (_RNG.rand(48, 64, 3).astype(np.float32), 2),
    (_RNG.rand(120, 160, 3).astype(np.float32), 4),
    ((_RNG.rand(48, 64) > 0.5), 2),
    (_RNG.rand(31, 45).astype(np.float32), 3),  # non-divisible: cropped
]


@pytest.mark.parametrize("arr,s", _CASES, ids=["f32", "f32x3", "s4", "bool", "crop"])
def test_decimate_matches_stride_slice(arr, s):
    hs, ws = arr.shape[0] // s, arr.shape[1] // s
    ref = arr[: hs * s : s, : ws * s : s]
    got = np.asarray(decimate(jnp.asarray(arr), s))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_decimate_identity():
    x = jnp.arange(12.0).reshape(3, 4)
    assert decimate(x, 1) is x
