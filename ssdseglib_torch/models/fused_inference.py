"""BN-folded serving forward for MobileNetV2 (PyTorch), counterpart of
ssdseglib_tpu/models/fused_inference.py, and for MobileNetV3-Large, the
port's own.

Every ConvBN is folded to conv + bias on the host (NumPy, f32, the same
arithmetic as the JAX package), then cast to the compute dtype.  The stem
absorbs the [0, 255] -> [-1, 1] input rescale (`fold_stem_rescale`), and in
bfloat16 every depthwise 3x3 conv runs as one Hopper kernel with its padding,
bias and activation (`ops/depthwise3x3.py`, the heads' too).
- MobileNetV2 (`mobilenetv2_features_fused`): the stem and the stride-2 /
  first blocks run as cuDNN convs but for their depthwise convs, and each
  stride-1 residual repeat runs as one fused Hopper kernel
  (`ops/fused_mbconv.py`).
- MobileNetV3-Large (`mobilenetv3_large_features_fused`): the 1x1 convs run
  on cuDNN, each followed by its activation pass (ReLU or h-swish); the
  squeeze-and-excitation keeps its two 1x1 convs with their biases; the six
  5x5 depthwise convs take the library route (cuDNN's grouped conv, bias,
  activation).  It takes none of the options below and no spatial mesh.
The heads run folded and without concats (`heads_forward_folded`).

Options of `make_fused_forward`, all off the default path (MobileNetV2's):
- ``s2d_stem="cuda"``: stem + block 1 as one fused Hopper kernel
  (`ops/s2d_stem.py`) for inputs whose height and width are multiples of
  4; the input rescale is then a pass of its own.
- ``s2d_stem="xla"``: stem + block 1 as the JAX package's conv
  reformulation (`ops/s2d_stem.s2d_stem_block1_xla`: space-to-depth, four
  images' channels packed side by side, library convs on the packed
  widths), for batches of a multiple of 4 whose height and width are
  multiples of 4, the weights packed once when the forward is built; the
  input rescale is a pass of its own.  The function is the kernel's, so on
  split rows it runs on the same window.  A batch or shape the gate refuses
  takes the plain stem, as in the JAX package.
- ``fused_heads=False``: the heads of `SsdSegModel` (unfolded, eval mode)
  under the folded backbone.
- ``fold_input_rescale=False``: the standalone rescale at every shape.
- ``quantize_pointwise=True``: int8 post-training quantization of the two
  `QUANT_TARGETS` pointwise convs, per-output-channel weight scales and
  per-tensor activation scales calibrated on ``calibration_images``; each
  runs as one int8 tensor-core kernel (`ops/int8_pointwise.py`).
`fused_operands` gives every tensor the forward reads and `fused_forward`
is the forward as a function of them, which ``torch.export`` captures with
the tensors as inputs (``export.py``); `make_fused_forward` binds the two.

Activations are NCHW in the channels-last memory format, so the NHWC view
the fused kernels take is a permute, not a copy.  The public forward takes
NHWC images and returns NHWC outputs, like the JAX package.

On a ``("data", "spatial")`` mesh (MobileNetV2; inside `parallel.mesh.data_parallel`,
on this rank's rows of the images) the forward runs under the model's row
partition, as `SsdSegModel.forward` does: every kernel of a split level runs
on this rank's window of rows (`parallel/spatial.py`), a whole level runs
whole on every rank, and the heads' outputs are gathered.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssdseglib_torch.config import ModelConfig
from ssdseglib_torch.models.blocks import bilinear_resize, conv2d_same
from ssdseglib_torch.models.mobilenetv2 import _SEQUENCES
from ssdseglib_torch.models.mobilenetv3 import BNECK, LAST_BLOCK, STEM_CHANNELS
from ssdseglib_torch.ops.depthwise3x3 import depthwise3x3
from ssdseglib_torch.ops.fused_mbconv import fold_conv_bn, fused_mbconv_rows
from ssdseglib_torch.ops.int8_pointwise import int8_pointwise
from ssdseglib_torch.ops.s2d_stem import (
    PACK,
    fused_stem_block1,
    pack_stem_block1,
    s2d_stem_block1_xla,
    stem_block1_args,
)
from ssdseglib_torch.parallel import spatial

EXTRA_BLOCKS = ("backbone-block17", "backbone-block18")


def _numpy_state(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {
        k: v.detach().cpu().float().numpy()
        for k, v in state_dict.items()
        if not k.endswith("num_batches_tracked")
    }


def _fold_convbn(s: Dict[str, np.ndarray], prefix: str):
    return fold_conv_bn(
        s[f"{prefix}.conv.weight"], s[f"{prefix}.batchnorm.weight"],
        s[f"{prefix}.batchnorm.bias"], s[f"{prefix}.batchnorm.running_mean"],
        s[f"{prefix}.batchnorm.running_var"],
    )


def _fold_sepconv(s: Dict[str, np.ndarray], prefix: str):
    """SepConvBN: BN sits after the pointwise conv only -- fold it into the
    pointwise kernel; the depthwise kernel passes through untouched."""
    pw, bias = fold_conv_bn(
        s[f"{prefix}.pointwise.weight"], s[f"{prefix}.batchnorm.weight"],
        s[f"{prefix}.batchnorm.bias"], s[f"{prefix}.batchnorm.running_mean"],
        s[f"{prefix}.batchnorm.running_var"],
    )
    return s[f"{prefix}.depthwise.weight"], pw, bias


def fold_mobilenetv2(state_dict) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Fold every backbone ConvBN into (OIHW kernel, bias), keyed by module
    name; a plain conv with a bias (MobileNetV3-Large's squeeze-and-
    excitations) passes as its (kernel, bias).  Folds either backbone of
    `FUSED_BACKBONES` under the JAX package's name."""
    s = _numpy_state(state_dict)
    names = dict.fromkeys(
        k.split(".")[1] for k in s if k.startswith("backbone.")
    )
    return {name: _fold_convbn(s, f"backbone.{name}") if f"backbone.{name}.conv.weight" in s
            else (s[f"backbone.{name}.weight"], s[f"backbone.{name}.bias"])
            for name in names}


def fold_heads(state_dict, cfg: ModelConfig) -> Dict[str, tuple]:
    """Fold every head-side ConvBN / SepConvBN into conv + bias, keyed by
    '/'-joined module path, like the JAX package's ``fold_heads``."""
    s = _numpy_state(state_dict)
    out = {}

    def convbn(path):
        out[path] = _fold_convbn(s, path.replace("/", "."))

    def sepconv(path):
        out[path] = _fold_sepconv(s, path.replace("/", "."))

    for name in EXTRA_BLOCKS:
        sepconv(name)
    convbn("mask-encoder/aspp-pointwise")
    for i in range(len(cfg.segmentation_dilation_rates)):
        sepconv(f"mask-encoder/aspp-atrous{i + 1}")
    convbn("mask-encoder/pooling")
    convbn("mask-encoder/output")
    convbn("mask-decoder/backbone-reduce")
    convbn("mask-decoder/conv")
    sepconv("mask-decoder/sepconv")
    out["mask-decoder/output-conv"] = (s["mask-decoder.output-conv.weight"],)
    for i in range(4):
        sepconv(f"heads/labels{i + 1}/sepconv")
        sepconv(f"heads/boxes{i + 1}/sepconv")
    return out


def fold_stem_rescale(kernel, bias, input_hw):
    """Fold the [0,255] -> [-1,1] input rescale into the (BN-folded) stem
    conv, whose kernel is OIHW.

    conv_SAME(x/127.5 - 1, k) + b == conv_SAME(x, k/127.5) + (b - ones(x)*k)
    where the correction term `conv_SAME(ones, k)` varies only near the
    borders (SAME zero-padding of the RESCALED image means gray padding of
    the raw one); it is precomputed here as a (1, C, H/2, W/2) bias map.
    The same NumPy arithmetic as the JAX package, on the HWIO kernel."""
    k = np.ascontiguousarray(np.asarray(kernel, np.float32).transpose(2, 3, 1, 0))
    h, w = int(input_hw[0]), int(input_hw[1])
    kh, kw = k.shape[:2]
    stride = 2
    hout, wout = -(-h // stride), -(-w // stride)
    pad_t = max((hout - 1) * stride + kh - h, 0) // 2
    pad_l = max((wout - 1) * stride + kw - w, 0) // 2
    # corr[ho, wo, o] = sum over in-bounds taps of k summed over in-channels
    ksum = k.sum(axis=2)  # (kh, kw, C_out)
    hi = np.arange(hout) * stride - pad_t
    wi = np.arange(wout) * stride - pad_l
    corr = np.zeros((hout, wout, k.shape[3]), np.float32)
    for dh in range(kh):
        vh = ((hi + dh >= 0) & (hi + dh < h)).astype(np.float32)
        for dw in range(kw):
            vw = ((wi + dw >= 0) & (wi + dw < w)).astype(np.float32)
            corr += ksum[dh, dw] * (vh[:, None] * vw[None, :])[..., None]
    bias_map = np.asarray(bias, np.float32) - corr[None]
    return (np.asarray(kernel, np.float32) / 127.5,
            np.ascontiguousarray(bias_map.transpose(0, 3, 1, 2)))


# `_conv`'s activations by name: (relu_cap, activation) of `ops/depthwise3x3.py`
# and the library route's pass
ACTIVATIONS = {
    None: ((None, None), lambda y: y),
    "relu6": ((6.0, None), lambda y: y.clamp(0.0, 6.0)),
    "relu": ((None, "relu"), F.relu),
    "hard_swish": ((None, "hard_swish"), F.hardswish),
}


def _depthwise3x3(x, kernel, bias, stride: int, dilation: int, act):
    """A bf16 depthwise 3x3 conv as one `ops/depthwise3x3.py` call on the
    NHWC view of the channels-last ``x`` (of its window of rows on split
    rows), the SAME padding, bias and activation ``act`` (of ACTIVATIONS)
    inside it; back as a channels-last view."""
    x, (top, bottom) = spatial.window_rows(x, 3, stride, dilation)
    left, right = spatial.same_pad(x.shape[3], 3, stride, dilation)
    relu_cap, activation = ACTIVATIONS[act][0]
    y = depthwise3x3(x.permute(0, 2, 3, 1).contiguous(), kernel, bias, stride, dilation,
                     (top, bottom, left, right), relu_cap, activation)
    return y.permute(0, 3, 1, 2)


def takes_depthwise_kernel(x, kernel) -> bool:
    """Whether `_conv` runs a depthwise conv of ``kernel`` on ``x`` through
    `_depthwise3x3`: a 3x3 one in bfloat16."""
    return x.dtype == torch.bfloat16 and tuple(kernel.shape[2:]) == (3, 3)


def _conv(x, kernel, bias=None, stride: int = 1, depthwise: bool = False,
          act=None, dilation: int = 1):
    """Folded conv + bias (+ the activation ``act``: None, 'relu6', 'relu'
    or 'hard_swish'), SAME padding.  A bias of more than one dimension is
    the stem's (1, C, H, W) border bias map of the global image, of which
    split rows take their own.  A depthwise 3x3 conv in bfloat16 runs
    `_depthwise3x3` (the kernel on the card, its plain version, the same
    library calls as below, on the CPU); float32 and other kernel sizes keep
    the library route on every device."""
    if depthwise and takes_depthwise_kernel(x, kernel):
        return _depthwise3x3(x, kernel, bias, stride, dilation, act)
    groups = x.shape[1] if depthwise else 1
    vector_bias = bias if bias is not None and bias.dim() == 1 else None
    y = conv2d_same(x, kernel, vector_bias, stride, dilation, groups)
    if bias is not None and vector_bias is None:
        y = y + spatial.own_rows(bias)
    return ACTIVATIONS[act][1](y)


def _act(x, relu_max):
    """None = no activation, 0.0 = uncapped ReLU, > 0 = capped ReLU."""
    if relu_max is None:
        return x
    return x.clamp(0.0, relu_max) if relu_max > 0.0 else F.relu(x)


def _quantize_weight_int8(kernel):
    """Per-output-channel symmetric int8 weight quantization of an OIHW
    kernel: (int8 kernel, (Co,) f32 dequant scale).  The JAX package's
    NumPy arithmetic on the HWIO transpose: the amax runs over the
    in-channel and tap axes."""
    k = np.asarray(kernel, np.float32)
    amax = np.max(np.abs(k), axis=(1, 2, 3))
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    kq = np.clip(np.round(k / scale[:, None, None, None]), -127, 127).astype(np.int8)
    return kq, scale


# The pointwise convs that ``quantize_pointwise`` runs in int8: the ASPP input
# pointwise (1x1 576 -> 256 at os16) and the decoder SepConv's pointwise half
# (1x1 256 -> 256 at os4), the JAX package's choice.  Each runs as one kernel
# (`ops/int8_pointwise.py`) that reads the activation once.
QUANT_TARGETS = ("mask-encoder/aspp-pointwise", "mask-decoder/sepconv-pw")
# the key of a target's tables among the operands
INT8_SUFFIX = "/int8"


def quantize_pointwise_weights(folded_heads_f32):
    """The int8 weight tables of QUANT_TARGETS from the f32 folded heads
    (`fold_heads`): {target: (int8 OIHW kernel, (Co,) w_scale, f32 bias)}.
    The bias stays f32 whatever the serving dtype, as in the JAX package."""
    k1, b1 = folded_heads_f32["mask-encoder/aspp-pointwise"]
    _, pw2, b2 = folded_heads_f32["mask-decoder/sepconv"]
    out = {}
    kq, ws = _quantize_weight_int8(k1)
    out["mask-encoder/aspp-pointwise"] = (kq, ws, np.asarray(b1, np.float32))
    kq, ws = _quantize_weight_int8(pw2)
    out["mask-decoder/sepconv-pw"] = (kq, ws, np.asarray(b2, np.float32))
    return out


def int8_tables(weights, amaxes, device) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """The kernel's operands of each target from `quantize_pointwise_weights`
    and the calibrated input amax of each (`calibrate_pointwise_scales`):
    {target: (wq (Co, Ci) int8, inv_x_scale () f32, dequant (Co,) f32,
    bias (Co,) f32)} on ``device``.  The scales are the JAX package's:
    ``x_scale = max(amax, 1e-6) / 127`` in float64, its f32 reciprocal (the
    constant that `_conv_int8` multiplies by) and the f32 product
    ``f32(w_scale) * f32(x_scale)``."""
    out = {}
    for name, (kq, w_scale, bias) in weights.items():
        x_scale = max(amaxes[name], 1e-6) / 127.0
        arrays = (kq.reshape(kq.shape[0], -1), np.asarray(1.0 / x_scale, np.float32),
                  np.asarray(w_scale, np.float32) * np.float32(x_scale),
                  np.asarray(bias, np.float32))
        out[name] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)
    return out


def _pointwise_int8(x, tables):
    """A quantized target on the NCHW channels-last ``x``: the kernel on its
    NHWC view, back as a channels-last view; ReLU6 included."""
    y = int8_pointwise(x.permute(0, 2, 3, 1).contiguous(), *tables)
    return y.permute(0, 3, 1, 2)


def _block_convs(folded, block: int):
    """The folded (kernel, bias) of a block's expand, depthwise, project."""
    return tuple(
        folded[f"backbone-block{block}-{stage}"]
        for stage in ("expand", "depthwise", "project")
    )


def _mbconv_args(folded, block: int):
    """Kernel-layout arguments of one stride-1 block from its OIHW folded
    convs: (Cin, E), (E,), (9, E), (E,), (E, Cout), (Cout,)."""
    (we, be), (wd, bd), (wp, bp) = _block_convs(folded, block)
    e = we.shape[0]
    return (
        we.reshape(e, -1).t().contiguous(), be,
        wd.reshape(e, 9).t().contiguous(), bd,
        wp.reshape(wp.shape[0], e).t().contiguous(), bp,
    )


# the key of each s2d_stem route's operands among `fused_operands`
STEM_OPERANDS = {"cuda": "backbone-stem-block1-args", "xla": "backbone-stem-block1-packed"}


def _check_s2d_stem(s2d_stem) -> None:
    if s2d_stem is not False and s2d_stem not in STEM_OPERANDS:
        # reject typos like 'cuba' / True instead of running another variant
        raise ValueError(f"s2d_stem must be False, 'cuda' or 'xla'; got {s2d_stem!r}")


def check_fused_options(cfg: ModelConfig, s2d_stem, quantize_pointwise) -> None:
    """ValueError for a backbone the fold does not take, and for the
    options (``s2d_stem``, ``quantize_pointwise``) on one that is not
    MobileNetV2's, whose layers they are built on (`FUSED_BACKBONES`)."""
    if cfg.backbone not in FUSED_BACKBONES:
        # the JAX package's message (it folds MobileNetV2 alone)
        raise ValueError("fused inference currently supports mobilenetv2 only")
    _check_s2d_stem(s2d_stem)
    if not FUSED_BACKBONES[cfg.backbone][1] and (s2d_stem or quantize_pointwise):
        raise ValueError(f"s2d_stem and quantize_pointwise are MobileNetV2's options; "
                         f"fused inference of {cfg.backbone} takes neither")


def _s2d_stem_applicable(x: torch.Tensor, s2d_stem="cuda") -> bool:
    """Shape gate of the stem + block 1 route on an NCHW input, the image's
    size read on the global image (a shard's rows are the mesh's, not the
    image's): the two stride-2 convs pad 0 before and 1 after only on even
    sizes; ``"xla"`` packs PACK images of this rank's batch together."""
    rows, cols = spatial.global_size(x)
    shape_ok = rows % 4 == 0 and cols % 4 == 0
    return shape_ok and (s2d_stem != "xla" or x.shape[0] % PACK == 0)


# image rows above and below a shard's own that its window holds for the
# stem + block 1 kernel: block 1's output row r reads the stem's rows
# 2r - 1 .. 2r + 3, which read image rows 4r - 2 .. 4r + 8.  The kernel pads
# the window's edges itself, so the output rows next to an inner edge are
# wrong and dropped: STEM_HALO[i] / 4 of them, which leaves every own row
# reading real rows only.  Multiples of 4 keep the window's rows a multiple
# of 4, as the kernel's two stride-2 convs need.
STEM_HALO = (4, 8)


def _stem_block1(x: torch.Tensor, folded, s2d_stem="cuda") -> torch.Tensor:
    """Stem + block 1 on the NCHW channels-last image ``x`` through the
    ``s2d_stem`` route, the kernel (``"cuda"``) or the packed convs
    (``"xla"``), on the NHWC view (a copy that view needs is counted on
    ``mobilenetv2_features_fused.copies``); on split rows on this rank's
    window of image rows (`STEM_HALO`), the window's halo outputs dropped;
    the whole image on every rank where block 1's output level is whole."""
    route = fused_stem_block1 if s2d_stem == "cuda" else s2d_stem_block1_xla
    args = folded[STEM_OPERANDS[s2d_stem]]
    rows, cols = spatial.global_size(x)
    if not spatial.split_at(-(-rows // 4), -(-cols // 4)):
        x = spatial.whole(x)
    window = spatial.edge_window(x, *STEM_HALO)
    if window is not None:
        launched = fused_stem_block1.launches
        y = route(window.rows.permute(0, 2, 3, 1).contiguous(), args)
        fused_stem_block1.window_launches += fused_stem_block1.launches - launched
        return y[:, window.top // 4:y.shape[1] - window.bottom // 4].permute(0, 3, 1, 2)
    nhwc = x.permute(0, 2, 3, 1)
    if not nhwc.is_contiguous():
        mobilenetv2_features_fused.copies += 1
        nhwc = nhwc.contiguous()
    return route(nhwc, args).permute(0, 3, 1, 2)


def mobilenetv2_features_fused(folded, x: torch.Tensor, s2d_stem=False):
    """Backbone forward on pre-scaled input ([-1, 1], or raw with the
    rescale folded into the stem); returns the three head taps (fm1 os16,
    fm2 os32, skip os4), NCHW.  ``folded`` holds the device tensors of every
    folded conv and, under ``backbone-block{N}-mbconv``, the kernel
    arguments of each stride-1 residual repeat.

    s2d_stem: ``"cuda"`` runs stem + block 1 as one fused kernel
    (`ops/s2d_stem.py`, arguments under ``backbone-stem-block1-args``),
    ``"xla"`` as the packed conv reformulation (under
    ``backbone-stem-block1-packed``), when the input allows it
    (`_s2d_stem_applicable`, `_stem_block1`).  Default off.  Each stride-1
    residual repeat runs the MBConv kernel (`ops/fused_mbconv.
    fused_mbconv_rows`: on split rows, on this rank's window)."""
    _check_s2d_stem(s2d_stem)
    use_s2d = bool(s2d_stem) and _s2d_stem_applicable(x, s2d_stem)
    if use_s2d:
        # a channels-last view, as the convs below take it
        x = _stem_block1(x, folded, s2d_stem)
    else:
        (we, be), (wd, bd), (wp, bp) = _block_convs(folded, 0)
        x = _conv(x, we, be, stride=2, act="relu6")
        x = _conv(x, wd, bd, depthwise=True, act="relu6")
        x = _conv(x, wp, bp)

    taps = {}
    block = 0
    for _, _, n_repeat, stride in _SEQUENCES:
        for n in range(n_repeat):
            block += 1
            if block == 1 and use_s2d:
                continue  # already inside the stem kernel
            if n == 0:
                # stride-s first block, no residual: cuDNN convs; expose the
                # expand activation (head taps live on first blocks)
                (we, be), (wd, bd), (wp, bp) = _block_convs(folded, block)
                e = _conv(x, we, be, act="relu6")
                taps[f"block{block}-expand"] = e
                d = _conv(e, wd, bd, stride=stride, depthwise=True, act="relu6")
                x = _conv(d, wp, bp)
            else:
                # stride-1 residual repeat: one fused kernel launch on the
                # NHWC view of the channels-last activation (of its window)
                x = fused_mbconv_rows(x, *folded[f"backbone-block{block}-mbconv"],
                                      residual=True)
        taps[f"block{block}-out"] = x

    return taps["block13-expand"], taps["block16-out"], taps["block3-expand"]


mobilenetv2_features_fused.copies = 0


def _squeeze_excite(x, reduce, expand):
    """`models.blocks.squeeze_excite` on the folded operands: x scaled by
    hard_sigmoid(expand(relu(reduce(mean of x over H x W)))), the two 1x1
    convs with their biases."""
    s = _conv(spatial.mean_hw(x), *reduce, act="relu")
    return x * F.hardsigmoid(_conv(s, *expand))


def mobilenetv3_large_features_fused(folded, x: torch.Tensor):
    """MobileNetV3-Large's backbone forward (`models/mobilenetv3.py`) on the
    folded convs, on pre-scaled input ([-1, 1], or raw with the rescale
    folded into the stem); returns the three head taps (fm1: block 13's
    expansion, os16; fm2: block 16's output, os32; skip: block 4's
    expansion, os4), NCHW.  Counters: ``.se_blocks`` (squeeze-and-
    excitations run, 8 a forward) and ``.library_depthwise`` (depthwise
    convs left to the library route: the six 5x5 ones in bfloat16, all 15
    in float32)."""
    x = _conv(x, *folded["backbone-block0-expand"], stride=2, act="hard_swish")
    taps = {}
    cin = STEM_CHANNELS
    for block, (_, e, cout, se, hs, stride) in enumerate(BNECK, 1):
        name, act = f"backbone-block{block}", "hard_swish" if hs else "relu"
        y = x
        if e != cin:
            y = taps[block] = _conv(x, *folded[f"{name}-expand"], act=act)
        kernel, bias = folded[f"{name}-depthwise"]
        if not takes_depthwise_kernel(y, kernel):
            mobilenetv3_large_features_fused.library_depthwise += 1
        y = _conv(y, kernel, bias, stride=stride, depthwise=True, act=act)
        if se:
            y = _squeeze_excite(y, folded[f"{name}-se-reduce"], folded[f"{name}-se-expand"])
            mobilenetv3_large_features_fused.se_blocks += 1
        y = _conv(y, *folded[f"{name}-project"])
        x = x + y if stride == 1 and cin == cout else y
        cin = cout
    x = _conv(x, *folded[f"backbone-block{LAST_BLOCK}-expand"], act="hard_swish")
    return taps[13], x, taps[4]


mobilenetv3_large_features_fused.se_blocks = 0
mobilenetv3_large_features_fused.library_depthwise = 0

# the backbones the fold takes: {name: (its features function, whether it
# is MobileNetV2's, with the MBConv operands and the options s2d_stem and
# quantize_pointwise)}
FUSED_BACKBONES = {
    "mobilenetv2": (mobilenetv2_features_fused, True),
    "mobilenetv3_large": (mobilenetv3_large_features_fused, False),
}


def heads_forward_folded(cfg: ModelConfig, folded, fm1, fm2, skip, quant=None,
                         collect_amax: bool = False):
    """BN-folded, concat-free forward of the task heads (NCHW in, NHWC
    out).  Each ``concat -> conv`` pair (the ASPP merge and the decoder skip
    merge) runs as a sum of per-branch convs over kernel slices, so the
    concatenation is never materialised; the pooled ASPP branch is
    spatially constant and enters as a bias.

    quant: {target: `int8_tables` entry} of the QUANT_TARGETS that run in
    int8 (on split rows as they are: a 1x1 reads no halo).  collect_amax:
    also return {target: max |input|} as 0-d tensors, the calibration's
    statistic (taken outside any row partition).

    Under a row partition the pooled ASPP branch is the global mean
    (`parallel.spatial.mean_hw`), the decoder resizes to the skip's global
    size, and each SSDLite branch's output is gathered whole before the
    reshape, as in `models/heads.py`."""
    relu_max = 6.0  # mobilenetv2 head cap (the int8 kernel's ReLU6)

    def sep(x, name, stride=1, dilation=1, rm=relu_max):
        dw, pw, b = folded[name]
        y = _conv(x, dw, None, stride=stride, depthwise=True, dilation=dilation)
        return _act(_conv(y, pw, b), rm)

    fm3 = sep(fm2, EXTRA_BLOCKS[0], stride=2)
    fm4 = sep(fm3, EXTRA_BLOCKS[1], stride=2)

    # -- ASPP encoder
    quant = quant or {}
    amaxes = {}
    if collect_amax:
        amaxes["mask-encoder/aspp-pointwise"] = fm1.abs().max()
    if "mask-encoder/aspp-pointwise" in quant:
        pw_out = _pointwise_int8(fm1, quant["mask-encoder/aspp-pointwise"])
    else:
        pw_out = _act(_conv(fm1, *folded["mask-encoder/aspp-pointwise"]), relu_max)
    atrous = [
        sep(fm1, f"mask-encoder/aspp-atrous{i + 1}", dilation=rate)
        for i, rate in enumerate(cfg.segmentation_dilation_rates)
    ]
    pooled = spatial.mean_hw(fm1)
    pooled = _act(_conv(pooled, *folded["mask-encoder/pooling"]), relu_max)
    ko, bo = folded["mask-encoder/output"]  # (F, 5F, 1, 1)
    f = ko.shape[0]
    enc = _conv(pw_out, ko[:, :f])
    for i, branch in enumerate(atrous):
        enc = enc + _conv(branch, ko[:, (i + 1) * f:(i + 2) * f])
    enc = enc + spatial.expand_rows(_conv(pooled, ko[:, (len(atrous) + 1) * f:], bo), enc)
    enc = _act(enc, relu_max)

    # -- DeepLabV3+ decoder: the 3x3 conv over concat([upsampled encoder,
    # reduced skip]) runs as two sliced convs
    enc_up = bilinear_resize(enc, *spatial.global_size(skip))
    red = _act(_conv(skip, *folded["mask-decoder/backbone-reduce"]), relu_max)
    kc, bc = folded["mask-decoder/conv"]  # (F, F + 48, 3, 3)
    x = _act(_conv(enc_up, kc[:, :f]) + _conv(red, kc[:, f:], bc), relu_max)
    # decoder SepConv, split so that its pointwise half can run int8
    dw_k, pw_k, b_sep = folded["mask-decoder/sepconv"]
    dw_out = _conv(x, dw_k, None, depthwise=True)
    if collect_amax:
        amaxes["mask-decoder/sepconv-pw"] = dw_out.abs().max()
    if "mask-decoder/sepconv-pw" in quant:
        x = _pointwise_int8(dw_out, quant["mask-decoder/sepconv-pw"])
    else:
        x = _act(_conv(dw_out, pw_k, b_sep), relu_max)
    (k_out,) = folded["mask-decoder/output-conv"]
    x = _conv(x, k_out)
    x = bilinear_resize(x, cfg.input_image_shape[0], cfg.input_image_shape[1])
    mask = torch.softmax(x, dim=1).permute(0, 2, 3, 1)

    # -- SSDLite branches (incl. the 4 / num_classes channel-swap quirk)
    head_rm = (
        cfg.detection_head_relu_max
        if cfg.detection_head_relu_max is not None
        else relu_max
    )
    fms = [fm1, fm2, fm3, fm4]
    b = fm1.shape[0]

    def branch(kind, channels):
        return torch.cat(
            [
                spatial.whole(sep(fm, f"heads/{kind}{i + 1}/sepconv", rm=head_rm))
                .permute(0, 2, 3, 1).reshape(b, -1, channels)
                for i, fm in enumerate(fms)
            ],
            dim=1,
        )

    labels = torch.softmax(branch("labels", 4), dim=-1)
    boxes = branch("boxes", cfg.number_of_classes)
    outputs = {"output-mask": mask, "output-labels": labels, "output-boxes": boxes}
    if collect_amax:
        return outputs, amaxes
    return outputs


def _to_device(folded, dtype, device):
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
        return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t

    return {name: tuple(put(a) for a in arrays) for name, arrays in folded.items()}


# the stem conv with the input rescale folded in (`fold_stem_rescale`), kept
# beside the plain stem, which inputs of another shape take
STEM_RESCALED = "backbone-block0-expand-rescaled"


def fused_operands(cfg: ModelConfig, state_dict, compute_dtype=torch.bfloat16,
                   device="cuda", s2d_stem=False, fold_input_rescale: bool = True,
                   heads: bool = True, quantize_pointwise: bool = False,
                   calibration_images=None) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Every tensor `fused_forward` reads, keyed by conv: the BN-folded
    backbone convs (OIHW kernel, bias), the stem with the input rescale
    folded in (under ``fold_input_rescale``, not under ``s2d_stem``), the
    kernels' arguments of each stride-1 residual repeat (MobileNetV2), the
    squeeze-and-excitations' convs (MobileNetV3-Large), the operands of the
    ``s2d_stem`` route (`STEM_OPERANDS`; ``"xla"``'s packed on the host from
    the f32 folds), with ``heads`` the folded head convs, and
    with ``quantize_pointwise`` the int8 tables of each QUANT_TARGETS conv
    (`int8_tables`, keyed ``target + INT8_SUFFIX``), calibrated on
    ``calibration_images`` by `calibrate_pointwise_scales`'s pass.  Folding
    runs in f32; the tensors are then cast to ``compute_dtype`` on
    ``device``, each in its own allocation (the int8 tables keep their
    types)."""
    check_fused_options(cfg, s2d_stem, quantize_pointwise)
    if quantize_pointwise and not heads:
        raise ValueError("quantize_pointwise requires fused_heads=True")
    if quantize_pointwise and calibration_images is None:
        raise ValueError(
            "quantize_pointwise requires calibration_images (a "
            "representative batch in [0, 255]) for the activation scales"
        )
    folded_f32 = fold_mobilenetv2(state_dict)
    operands = _to_device(folded_f32, compute_dtype, device)
    if fold_input_rescale and not s2d_stem:
        operands[STEM_RESCALED] = _to_device(
            {"stem": fold_stem_rescale(*folded_f32["backbone-block0-expand"],
                                       cfg.input_image_shape[:2])},
            compute_dtype, device,
        )["stem"]
    if s2d_stem == "cuda":
        operands[STEM_OPERANDS["cuda"]] = stem_block1_args(operands)
    elif s2d_stem == "xla":
        operands[STEM_OPERANDS["xla"]] = _to_device(
            {"packed": pack_stem_block1(folded_f32)}, compute_dtype, device)["packed"]
    block = 0
    for _, _, n_repeat, _ in _SEQUENCES if FUSED_BACKBONES[cfg.backbone][1] else ():
        for n in range(n_repeat):
            block += 1
            if n > 0:
                operands[f"backbone-block{block}-mbconv"] = _mbconv_args(operands, block)
    if heads:
        heads_f32 = fold_heads(state_dict, cfg)
        operands.update(_to_device(heads_f32, compute_dtype, device))
        if quantize_pointwise:
            amaxes = _calibrate(cfg, operands, calibration_images)
            tables = int8_tables(quantize_pointwise_weights(heads_f32), amaxes, device)
            operands.update({name + INT8_SUFFIX: t for name, t in tables.items()})
    return operands


@torch.inference_mode()
def _calibrate(cfg: ModelConfig, operands, images) -> Dict[str, float]:
    """The input amax of every QUANT_TARGETS conv over ``images`` (NHWC, in
    [0, 255]), through the backbone and heads of ``operands`` in their
    dtype: the plain stem after the standalone rescale, as the JAX package
    calibrates, whatever the serving stem.  Outside any mesh scope: on a
    mesh every rank calibrates on the whole batch with the replicated
    weights, so every rank holds one process's tables."""
    weight = operands["backbone-block0-expand"][0]
    images = images if isinstance(images, torch.Tensor) else torch.from_numpy(
        np.asarray(images))
    x = images.to(weight.device).to(weight.dtype).permute(0, 3, 1, 2) / 127.5 - 1.0
    fm1, fm2, skip = mobilenetv2_features_fused(operands, x)
    _, amaxes = heads_forward_folded(cfg, operands, fm1, fm2, skip, collect_amax=True)
    return {name: float(amax) for name, amax in amaxes.items()}


def calibrate_pointwise_scales(cfg: ModelConfig, state_dict, images,
                               compute_dtype=torch.bfloat16, device="cuda"
                               ) -> Dict[str, float]:
    """One pass of the folded pipeline over calibration ``images`` (NHWC, in
    [0, 255]) in the SERVING compute dtype, on ``device`` (the MBConv kernel
    on the card), recording the input amax of every QUANT_TARGETS conv:
    {target: float amax}."""
    operands = fused_operands(cfg, state_dict, compute_dtype, device,
                              fold_input_rescale=False)
    return _calibrate(cfg, operands, images)


def fused_forward(cfg: ModelConfig, operands: Mapping[str, Tuple[torch.Tensor, ...]],
                  images: torch.Tensor, s2d_stem=False, apply_heads=None) -> dict:
    """The BN-folded forward on NHWC ``images`` (any real or uint8 dtype)
    with the tensors of `fused_operands`: a dict of NHWC outputs.  A
    function of its arguments only, so ``torch.export`` captures it with
    the operands as inputs.  ``apply_heads`` replaces the folded heads.
    Inside a `parallel.mesh.data_parallel` scope whose mesh splits the rows,
    ``images`` are this rank's rows and the forward runs under the model's
    row partition (with `SsdSegModel.forward`'s halos): the outputs are
    this rank's rows of the mask and the whole heads' outputs."""
    halos = {16: max(cfg.segmentation_dilation_rates)}
    with spatial.row_partition(images, halos):
        x = images.to(operands["backbone-block0-expand"][0].dtype).permute(0, 3, 1, 2)
        backbone = operands
        if STEM_RESCALED in operands and (
                spatial.global_size(x) == tuple(cfg.input_image_shape[:2])):
            # raw-input path: rescale folded into the stem
            backbone = {**operands, "backbone-block0-expand": operands[STEM_RESCALED]}
        else:
            x = x / 127.5 - 1.0
        features, mobilenetv2 = FUSED_BACKBONES[cfg.backbone]
        fm1, fm2, skip = (features(backbone, x, s2d_stem=s2d_stem) if mobilenetv2
                          else features(backbone, x))
        if apply_heads is not None:
            return apply_heads(fm1, fm2, skip)
        quant = {name: operands[name + INT8_SUFFIX] for name in QUANT_TARGETS
                 if name + INT8_SUFFIX in operands}
        return heads_forward_folded(cfg, operands, fm1, fm2, skip, quant=quant)


def make_fused_forward(cfg: ModelConfig, state_dict, compute_dtype=torch.bfloat16,
                       device="cuda", s2d_stem=False, fused_heads: bool = True,
                       fold_input_rescale: bool = True, quantize_pointwise: bool = False,
                       calibration_images=None) -> Callable[[torch.Tensor], dict]:
    """Build the BN-folded serving forward with the outputs of
    ``SsdSegModel`` in eval mode: a function of NHWC images (any real or
    uint8 dtype, on ``device``) returning the dict of NHWC outputs.

    fold_input_rescale: absorb the [0, 255] -> [-1, 1] rescale into the stem
    conv for images of ``cfg.input_image_shape``; any other spatial shape
    takes the standalone rescale (the border bias map is shape-specific).
    Off under ``s2d_stem``, whose kernel takes the rescaled image.

    s2d_stem: ``"cuda"`` runs stem + block 1 as one fused kernel, ``"xla"``
    as the packed conv reformulation (see `mobilenetv2_features_fused`).
    fused_heads: run the task heads through the BN-folded, concat-free
    `heads_forward_folded`; ``False`` runs the heads of `SsdSegModel` as
    they are.  Folding runs in f32; the weights
    are then cast to ``compute_dtype``.

    quantize_pointwise: run the QUANT_TARGETS pointwise convs in int8
    (per-output-channel weight scales, per-tensor activation scales
    calibrated on ``calibration_images``, a representative batch in
    [0, 255], which is then required).  Opt-in post-training quantization;
    requires ``fused_heads``."""
    check_fused_options(cfg, s2d_stem, quantize_pointwise)
    device = torch.device(device)
    operands = fused_operands(cfg, state_dict, compute_dtype, device, s2d_stem,
                              fold_input_rescale, heads=fused_heads,
                              quantize_pointwise=quantize_pointwise,
                              calibration_images=calibration_images)
    apply_heads = None
    if not fused_heads:
        from ssdseglib_torch.models.builder import SsdSegModel

        model = SsdSegModel(cfg, torch.Generator().manual_seed(0))
        model.load_state_dict(state_dict)
        del model["backbone"]
        model = model.to(device=device, dtype=compute_dtype)
        apply_heads = model.to(memory_format=torch.channels_last).eval().apply_heads

    @torch.inference_mode()
    def forward(images: torch.Tensor) -> dict:
        return fused_forward(cfg, operands, images, s2d_stem, apply_heads)

    return forward
