"""The fused MBConv wrapper's plain twin (what it runs on a CPU tensor)
against the JAX Pallas kernel in interpret mode, at the five (Cin, E, Cout)
widths of the 480x640 serving path and reduced spatial sizes.  The CUDA
kernel itself is held against the same twin on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.ops import fused_mbconv as tpu_ops
from ssdseglib_torch.ops.fused_mbconv import (
    fold_conv_bn,
    fused_mbconv,
    fused_mbconv_reference,
)

# (Cin, E, Cout) of blocks 2, 4-5, 7-9, 11-12, 14-15 at 480x640
SLICE_WIDTHS = [(24, 144, 24), (32, 192, 32), (64, 384, 64), (96, 576, 96),
                (160, 960, 160)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
          # 2 bf16 ulps of the reference value
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _block(seed, cin, e, cout, h, w):
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x = draw(2, h, w, cin)
    weights = (draw(cin, e, scale=cin ** -0.5), draw(e, scale=0.1),
               draw(3, 3, 1, e, scale=1 / 3), draw(e, scale=0.1),
               draw(e, cout, scale=e ** -0.5), draw(cout, scale=0.1))
    return x, weights


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw,residual", [((12, 16), True), ((15, 20), True),
                                         ((12, 16), False)])
@pytest.mark.parametrize("cin,e,cout", SLICE_WIDTHS)
def test_twin_matches_pallas_kernel(cin, e, cout, hw, residual, dtype):
    _, jdt, tdt, tol = DTYPES[dtype]
    x, weights = _block(cin + e, cin, e, cout, *hw)
    expected = tpu_ops.fused_mbconv(
        jnp.asarray(x, jdt), *(jnp.asarray(a) for a in weights),
        residual=residual, interpret=True,
    )
    # the wrapper takes weights already cast to x's dtype, as the JAX
    # wrapper casts them (fused_mbconv.py:164-166)
    before = fused_mbconv.launches
    got = fused_mbconv(
        torch.from_numpy(x).to(tdt),
        *(torch.from_numpy(a).to(tdt) for a in weights),
        residual=residual,
    )
    assert fused_mbconv.launches == before  # a CPU tensor never launches
    assert got.dtype == tdt and tuple(got.shape) == (2,) + hw + (cout,)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(expected.astype(jnp.float32)),
        rtol=tol, atol=tol,
    )


def test_fold_conv_bn_equals_jax():
    rng = np.random.default_rng(3)
    kernel = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)  # HWIO
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    beta = rng.normal(size=16).astype(np.float32)
    mean = rng.normal(size=16).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    k_jax, b_jax = tpu_ops.fold_conv_bn(kernel, gamma, beta, mean, var)
    k_port, b_port = fold_conv_bn(kernel.transpose(3, 2, 0, 1), gamma, beta, mean, var)
    np.testing.assert_array_equal(k_port, k_jax.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(b_port, b_jax)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    x, weights = _block(0, 16, 32, 8, 4, 5)
    xt = torch.from_numpy(x)
    wt = [torch.from_numpy(a) for a in weights]
    with pytest.raises(ValueError, match="residual"):
        fused_mbconv(xt, *wt, residual=True)  # Cin 16 != Cout 8
    with pytest.raises(ValueError, match="dtype"):
        fused_mbconv(xt.double(), *(w.double() for w in wt), residual=False)
    with pytest.raises(ValueError, match="x is"):
        fused_mbconv(xt, *wt[:5], wt[5].to(torch.bfloat16), residual=False)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mbconv(xt.transpose(1, 2), *wt, residual=False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_mbconv(xt.to("meta"), *(w.to("meta") for w in wt), residual=False)
    # the twin takes the JAX layouts as well: (1,1,Cin,E) / (3,3,1,E)
    got = fused_mbconv(xt, wt[0][None, None], wt[1], wt[2], wt[3], wt[4], wt[5],
                       residual=False)
    ref = fused_mbconv_reference(xt, wt[0], wt[1], wt[2].reshape(9, -1), wt[3],
                                 wt[4], wt[5], residual=False)
    assert torch.equal(got, ref)
