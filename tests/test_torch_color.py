"""The port's color ops (ssdseglib_torch/ops/color.py) against
ssdseglib_tpu/ops/color.py on the CPU, same inputs made with NumPy.

Tolerances: hue, saturation and value each 1e-6 (hue compared modulo 1: a
hue a rounding below 1 and a hue of 0 are the same colour); every adjusted
or augmented image 1e-3 on the [0, 255] scale (the HSV round trip multiplies
f32 roundings by up to 255).  The random augmentation is compared by
re-deriving the JAX package's four scalars with its own
``jax.random.split`` / ``uniform`` sequence and injecting them into the
port's pure function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.ops import color as jax_color

from ssdseglib_torch.ops import color
from tests.torch_parity import two_torch_threads  # noqa: F401 (autouse fixture)

IMAGE_TOLERANCE = 1e-3  # on [0, 255]


@pytest.fixture(scope="module")
def images():
    """(4, 12, 16, 3) f32 in [0, 255] with the awkward pixels planted: greys
    (c == 0), black (v == 0), ties of the maximum between two channels, and
    pure primaries."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 255.0, size=(4, 12, 16, 3)).astype(np.float32)
    x[0, 0, 0] = (0.0, 0.0, 0.0)
    x[0, 0, 1] = (128.0, 128.0, 128.0)
    x[0, 0, 2] = (200.0, 200.0, 10.0)   # r == g is the maximum
    x[0, 0, 3] = (10.0, 200.0, 200.0)   # g == b is the maximum
    x[0, 0, 4] = (200.0, 10.0, 200.0)   # r == b is the maximum
    x[0, 0, 5] = (255.0, 0.0, 0.0)
    x[0, 0, 6] = (0.0, 255.0, 0.0)
    x[0, 0, 7] = (0.0, 0.0, 255.0)
    x[0, 0, 8] = (255.0, 0.0, 1.0)      # (g - b) / c < 0: the negative modulo
    x[1] = np.round(x[1])               # integer pixel values, as decoded images have
    return x


def _wrapped(a, b, period=1.0):
    d = np.abs(a - b)
    return np.minimum(d, period - d)


def test_rgb_to_hsv_matches_jax(images):
    want = np.asarray(jax_color.rgb_to_hsv(jnp.asarray(images)))
    got = color.rgb_to_hsv(torch.from_numpy(images)).numpy()
    assert _wrapped(got[..., 0], want[..., 0]).max() <= 1e-6
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=1e-6, atol=1e-6)
    assert got[..., 0].min() >= 0.0 and got[..., 0].max() < 1.0


def test_hsv_to_rgb_matches_jax_and_round_trips(images):
    rng = np.random.default_rng(1)
    hsv = np.stack([rng.uniform(-1.5, 2.5, (6, 7)), rng.uniform(0, 1, (6, 7)),
                    rng.uniform(0, 255, (6, 7))], axis=-1).astype(np.float32)
    hsv[0, 0, 0], hsv[0, 1, 0], hsv[0, 2, 0] = -1e-8, 1.0, 5.0 / 6.0  # sector edges
    want = np.asarray(jax_color.hsv_to_rgb(jnp.asarray(hsv)))
    got = color.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_TOLERANCE)
    t = torch.from_numpy(images)
    np.testing.assert_allclose(color.hsv_to_rgb(color.rgb_to_hsv(t)).numpy(), images,
                               rtol=0, atol=IMAGE_TOLERANCE)


@pytest.mark.parametrize("name, value", [
    ("adjust_hue", -0.05), ("adjust_hue", 0.3), ("adjust_hue", -0.7),
    ("adjust_saturation", 0.95), ("adjust_saturation", 1.6), ("adjust_saturation", 0.0),
    ("adjust_contrast", 0.9), ("adjust_contrast", 1.1),
    ("adjust_brightness", -0.1), ("adjust_brightness", 12.5),
])
def test_adjustments_match_jax(images, name, value):
    want = np.asarray(getattr(jax_color, name)(jnp.asarray(images), jnp.float32(value)))
    got = getattr(color, name)(torch.from_numpy(images), value).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_TOLERANCE)
    # a 0-d tensor is taken like a float
    again = getattr(color, name)(torch.from_numpy(images), torch.tensor(value)).numpy()
    np.testing.assert_allclose(again, got, rtol=0, atol=1e-4)


def jax_rgb_scalars(key):
    """The four scalars ``augmentation_rgb_channels`` draws from ``key``."""
    k_hue, k_sat, k_con, k_bri = jax.random.split(key, 4)
    return (float(jax.random.uniform(k_hue, (), minval=-0.05, maxval=0.05)),
            float(jax.random.uniform(k_sat, (), minval=0.95, maxval=1.05)),
            float(jax.random.uniform(k_con, (), minval=0.90, maxval=1.10)),
            float(jax.random.uniform(k_bri, (), minval=-0.10, maxval=0.10)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentation_matches_jax_with_injected_scalars(images, seed):
    key = jax.random.key(seed)
    want = np.asarray(jax_color.augmentation_rgb_channels(key, jnp.asarray(images)))
    got = color.apply_rgb_augmentation(torch.from_numpy(images), *jax_rgb_scalars(key)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_TOLERANCE)
    assert got.min() >= 0.0 and got.max() <= 255.0


def test_drawn_augmentation_is_seeded_bounded_and_batch_wide(images):
    t = torch.from_numpy(images)
    draws = torch.stack([color.draw_rgb_scalars(torch.Generator().manual_seed(s))
                         for s in range(200)])
    for column, (low, high) in enumerate(color.RANGES):
        assert draws[:, column].min() >= low and draws[:, column].max() < high
        assert draws[:, column].max() - draws[:, column].min() > 0.8 * (high - low)
    a = color.augmentation_rgb_channels(torch.Generator().manual_seed(7), t)
    b = color.augmentation_rgb_channels(torch.Generator().manual_seed(7), t)
    c = color.augmentation_rgb_channels(torch.Generator().manual_seed(8), t)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == t.shape and a.min() >= 0.0 and a.max() <= 255.0
    # one draw for the whole batch: it equals the pure function of that draw
    scalars = color.draw_rgb_scalars(torch.Generator().manual_seed(7))
    assert torch.equal(a, color.apply_rgb_augmentation(t, *scalars.unbind(0)))
