"""int8 pointwise serving on the port (``quantize_pointwise``): the weight
quantization, the calibration, the int8 op's plain version, the quantized
folded heads and the quantized forward against the JAX package's, on the
CPU at SMALL_CFG in f32 (the JAX side's Pallas kernels in interpret mode);
the op's registration, a quantized serving bundle, and the builder's
keywords against the JAX builder's."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdseglib_tpu.models import builder as tpu_builder
from ssdseglib_tpu.models import fused_inference as tpu_fused
from ssdseglib_torch.config import ModelConfig as PortModelConfig
from ssdseglib_torch.export import load_serving_bundle
from ssdseglib_torch.models import builder as port_builder
from ssdseglib_torch.models import fused_inference as port_fused
from ssdseglib_torch.ops import int8_pointwise as port_op
from tests.torch_parity import (  # noqa: F401
    SMALL_CFG,
    images,
    jax_model_and_variables,
    port_model,
    source_constants,
    two_torch_threads,
)

PORT_CFG = PortModelConfig(**vars(SMALL_CFG))
TARGETS = ("mask-encoder/aspp-pointwise", "mask-decoder/sepconv-pw")


@pytest.fixture(scope="module")
def jax_side():
    """The one JAX quantized build of the file: the bridged weights, the
    calibration batch, the JAX forward's outputs on it and the amaxes its
    calibration recorded (read as `make_fused_forward` calls
    `calibrate_pointwise_scales`)."""
    _, variables = jax_model_and_variables(SMALL_CFG)
    state = port_model(SMALL_CFG, variables).state_dict()
    x = images(7, (2, 96, 128, 3))
    recorded = {}
    real = tpu_fused.calibrate_pointwise_scales

    def spy(*args, **kwargs):
        recorded.update(real(*args, **kwargs))
        return dict(recorded)

    tpu_fused.calibrate_pointwise_scales = spy
    try:
        forward = tpu_fused.make_fused_forward(
            SMALL_CFG, variables, compute_dtype=jnp.float32, interpret=True,
            quantize_pointwise=True, calibration_images=x)
    finally:
        tpu_fused.calibrate_pointwise_scales = real
    expected = {k: np.asarray(v) for k, v in forward(jnp.asarray(x)).items()}
    return variables, state, x, expected, recorded


def _jax_quant(variables, amaxes):
    """JAX's tables as its make_fused_forward builds them."""
    return {name: (kq, ws, max(amaxes[name], 1e-6) / 127.0, b)
            for name, (kq, ws, b) in tpu_fused.quantize_pointwise_weights(
                tpu_fused.fold_heads(variables, SMALL_CFG)).items()}


def _port_tables(state, amaxes):
    return port_fused.int8_tables(
        port_fused.quantize_pointwise_weights(port_fused.fold_heads(state, PORT_CFG)),
        amaxes, "cpu")


def _compare(expected, got, tol):
    for key in ("output-mask", "output-labels", "output-boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(expected[key]), rtol=tol,
                                   atol=tol, err_msg=key)


# -- (a) weight quantization --------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 576, 256), (3, 3, 24, 40), (1, 1, 72, 8)])
def test_quantize_weight_int8_equals_jax_bit_for_bit(shape):
    rng = np.random.default_rng(3)
    k = rng.normal(0, 0.2, shape).astype(np.float32)
    k[..., 1] = 0.0  # an all-zero output channel takes scale 1
    kq_jax, ws_jax = tpu_fused._quantize_weight_int8(k)
    kq, ws = port_fused._quantize_weight_int8(k.transpose(3, 2, 0, 1))  # HWIO -> OIHW
    assert kq.dtype == np.int8 and ws.dtype == np.float32 and ws[1] == 1.0
    np.testing.assert_array_equal(kq.transpose(2, 3, 1, 0), kq_jax)
    np.testing.assert_array_equal(ws, ws_jax)


def test_quantize_pointwise_weights_equals_jax(jax_side):
    variables, state = jax_side[:2]
    theirs = tpu_fused.quantize_pointwise_weights(tpu_fused.fold_heads(variables, SMALL_CFG))
    ours = port_fused.quantize_pointwise_weights(port_fused.fold_heads(state, PORT_CFG))
    assert tuple(ours) == tuple(theirs) == port_fused.QUANT_TARGETS == tpu_fused.QUANT_TARGETS
    for name, (kq, ws, b) in theirs.items():
        np.testing.assert_array_equal(ours[name][0].transpose(2, 3, 1, 0), kq, err_msg=name)
        np.testing.assert_array_equal(ours[name][1], ws, err_msg=name)
        np.testing.assert_array_equal(ours[name][2], b, err_msg=name)
        assert ours[name][2].dtype == np.float32


# -- (b) the op's plain version against JAX's _conv_int8 ---------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 6, 8, 576, 256), (3, 5, 7, 72, 40)],
                         ids=["aspp", "ragged"])
def test_plain_version_equals_jax_conv_int8(shape, dtype):
    """Same s8 activations; the output equal, or 1 ulp where XLA contracts
    the dequantize multiply and the bias add into one FMA (the port rounds
    both, as the kernel does)."""
    b, h, w, ci, co = shape
    rng = np.random.default_rng(11)
    x = rng.normal(0, 2.0, (b, h, w, ci)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    k = rng.normal(0, 0.1, (1, 1, ci, co)).astype(np.float32)
    bias = rng.normal(0, 1.0, co).astype(np.float32)
    kq, ws = tpu_fused._quantize_weight_int8(k)
    amax = 0.8 * float(np.abs(x).max())  # some activations clip at +-127
    x_scale = max(amax, 1e-6) / 127.0
    xj = jnp.asarray(x, jnp.dtype(dtype))
    want = np.asarray(tpu_fused._act(tpu_fused._conv_int8(xj, kq, ws, x_scale, bias), 6.0)
                      .astype(jnp.float32))
    want_q = np.asarray(jnp.clip(jnp.round(xj.astype(jnp.float32) * (1.0 / x_scale)),
                                 -127.0, 127.0).astype(jnp.int8))

    kq_port, ws_port = port_fused._quantize_weight_int8(k.transpose(3, 2, 0, 1))
    tables = port_fused.int8_tables({"t": (kq_port, ws_port, bias)}, {"t": amax}, "cpu")["t"]
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got_q = port_op.quantize_activations(xt, tables[1])
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    assert (np.abs(want_q) == 127).any()
    got = port_op.int8_pointwise(xt, *tables)
    assert got.dtype == xt.dtype and tuple(got.shape) == (b, h, w, co)
    got = got.float().numpy()
    spacing = np.spacing(np.abs(want).astype(np.float32))
    if dtype == "bfloat16":
        spacing = spacing * 2.0 ** 16  # a bf16 ulp
    assert np.all(np.abs(got - want) <= spacing), float(np.abs(got - want).max())


def test_plain_version_is_the_op_on_the_cpu():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (4, 5, 64)).astype(np.float32))
    args = (torch.from_numpy(rng.integers(-127, 128, (16, 64), dtype=np.int8)),
            torch.tensor(40.0), torch.from_numpy(rng.uniform(1e-4, 1e-3, 16).astype(np.float32)),
            torch.from_numpy(rng.normal(0, 1, 16).astype(np.float32)))
    before = port_op.int8_pointwise.launches
    assert torch.equal(port_op.int8_pointwise(x, *args),
                       port_op.int8_pointwise_reference(x, *args))
    assert port_op.int8_pointwise.launches == before  # the CPU launches no kernel


@pytest.mark.parametrize("bad, match", [
    (dict(co=12), "Co must be"), (dict(ci=12), "Ci must be"), (dict(ci=1032), "at most"),
    (dict(wq_dtype=torch.float32), "wq must be int8"),
])
def test_op_refuses_what_the_kernel_cannot_take(bad, match):
    ci, co = bad.get("ci", 64), bad.get("co", 16)
    x = torch.zeros(3, ci)
    wq = torch.zeros(co, ci, dtype=bad.get("wq_dtype", torch.int8))
    with pytest.raises(ValueError, match=match):
        port_op.int8_pointwise(x, wq, torch.tensor(1.0), torch.ones(co), torch.zeros(co))


# -- (b2) the kernel's launch plan ---------------------------------------------

PLAN_CASES = [(ci, co, dtype) for ci in (8, 72, 256, 576, 1024)
              for co in (8, 40, 136, 256, 264, 1024)
              for dtype in (torch.bfloat16, torch.float32)]


def _cta_items(plan, cta):
    """(chunk of Co, tile of rows, consumer warpgroup) of CTA ``cta``'s items
    in the order csrc/int8_pointwise.cu's kernel takes them."""
    grouped = plan.n_co <= plan.grid
    chunks = (range(cta % plan.n_co, plan.n_co, plan.n_co) if grouped
              else range(cta, plan.n_co, plan.grid))
    tiles = (range(cta // plan.n_co, plan.n_tiles, plan.grid // plan.n_co) if grouped
             else range(plan.n_tiles))
    n_wg = 2 if plan.stages >= 2 else 1
    j = 0
    for chunk in chunks:
        for tile in tiles:
            yield chunk, tile, j % n_wg
            j += 1


def test_plan_follows_the_kernel_source_s_geometry():
    got = source_constants("int8_pointwise.cu", "kTileRows", "kChunk", "kBlock", "kBox",
                           "kMaxStages", "kAlign", "kMaxCi")
    assert got == {"kTileRows": port_op.TILE_ROWS, "kChunk": port_op.CHUNK,
                   "kBlock": port_op.BLOCK, "kBox": port_op.BOX,
                   "kMaxStages": port_op.MAX_STAGES, "kAlign": port_op.ALIGN,
                   "kMaxCi": port_op.MAX_CI}


@pytest.mark.parametrize("ci, co, dtype", PLAN_CASES,
                         ids=[f"{ci}-{co}-{str(d)[6:]}" for ci, co, d in PLAN_CASES])
def test_plan_fits_shared_memory_and_covers_every_row_once(ci, co, dtype):
    """For every accepted (Ci, Co, dtype) and a range of row counts on a
    132-SM card: the plan's shared memory (ring, resident weights, s8 and
    staging tiles, tables, barriers) stays within the 227 KB a block may
    have, every (chunk of Co, tile of 64 rows) item goes to exactly one CTA,
    the tiles cover rows 0 .. R - 1 once, the chunks Co once, and a CTA's
    items alternate between its warpgroups when both have a ring."""
    for rows in (1, 63, 64, 65, 1000, 19_200, 307_200):
        for ctas_per_sm in (1, 2):
            plan = port_op._plan(rows, ci, co, dtype, 132, ctas_per_sm=ctas_per_sm)
            elem = 2 if dtype == torch.bfloat16 else 4
            stage = port_op.TILE_ROWS * port_op.CHUNK * elem
            assert 1 <= plan.stages <= port_op.MAX_STAGES
            assert plan.smem <= port_op.SMEM_LIMIT == 232_448
            assert plan.smem == port_op._fixed_bytes(plan.nc, plan.n_k) + plan.stages * stage
            assert plan.nc * port_op.BLOCK * plan.n_k * port_op.CHUNK < plan.smem
            assert plan.kp32 >= ci and plan.kp32 % 32 == 0 and plan.n_k * port_op.CHUNK >= ci
            assert 1 <= plan.grid <= 132 * ctas_per_sm
            seen = {}
            for cta in range(plan.grid):
                last_wg = None
                for chunk, tile, wg in _cta_items(plan, cta):
                    assert (chunk, tile) not in seen, (chunk, tile, cta, seen.get((chunk, tile)))
                    seen[chunk, tile] = cta
                    if plan.stages >= 2 and last_wg is not None:
                        assert wg == 1 - last_wg
                    last_wg = wg
            assert set(seen) == {(c, t) for c in range(plan.n_co) for t in range(plan.n_tiles)}
            covered = np.zeros(rows, np.int64)
            for t in range(plan.n_tiles):
                covered[t * port_op.TILE_ROWS:(t + 1) * port_op.TILE_ROWS] += 1
            assert (covered == 1).all() and plan.n_tiles * port_op.TILE_ROWS - rows < 64
            width = plan.nc * port_op.BLOCK
            assert (plan.n_co - 1) * width < co <= plan.n_co * width


def test_plan_at_the_serving_shapes():
    """The two quantized convs of a b16 480x640 forward: the decoder's 256 ->
    256 keeps all its weights resident (one chunk of Co); the ASPP's 576 ->
    256 (160 KB of weights in 128-byte rows) splits Co between pairs of
    CTAs; both keep a ring of 5 bf16 stages (80 KB of x in flight an SM)
    and fill the card with one CTA an SM."""
    decoder = port_op._plan(16 * 120 * 160, 256, 256, torch.bfloat16, 132)
    aspp = port_op._plan(16 * 30 * 40, 576, 256, torch.bfloat16, 132)
    assert (decoder.nc, decoder.n_co, decoder.stages, decoder.grid) == (2, 1, 5, 132)
    assert (aspp.nc, aspp.n_co, aspp.stages, aspp.grid) == (1, 2, 5, 132)
    assert (aspp.n_tiles, decoder.n_tiles) == (300, 4800)


# -- (c) calibration ----------------------------------------------------------


def test_calibration_matches_jax(jax_side):
    _, state, x, _, recorded = jax_side
    got = port_fused.calibrate_pointwise_scales(PORT_CFG, state, x, torch.float32, "cpu")
    assert set(got) == set(recorded) == set(TARGETS)
    for name in TARGETS:
        assert isinstance(got[name], float)
        assert got[name] == pytest.approx(recorded[name], rel=1e-5), name


# -- (d) the quantized folded heads -------------------------------------------


# Where the decoder's int8 input can differ between the two packages: each
# side computes that depthwise output with its own f32 convs (measured: 8e-6
# apart at most), so an activation within that noise of a rounding boundary
# takes the neighbouring level on one side (6 of the 393,216 of two 96x128
# images here).  At most this many, one level each:
DECODER_FLIPS = 16
# A flip changes one pixel of the decoder's os4 map; the 3x3 output conv
# spreads it one os4 pixel and the bilinear resize to full size one more (it
# reads the two source pixels around each sample), so it reaches the mask
# within FLIP_REACH os4 pixels, where the mask is held to the JAX package's
# own int8 bound (tests/test_fused_inference.py: 0.05); 1e-5 elsewhere.
FLIP_REACH = 2
INT8_MASK_BOUND = 0.05


def test_quantized_heads_match_jax(jax_side, monkeypatch):
    """The same fm1, fm2, skip and the same tables through both packages'
    quantized heads: the ASPP pointwise quantizes the same input on both
    sides (the same levels); the decoder's quantizes a depthwise output that
    each side computes itself (`DECODER_FLIPS`, `FLIP_REACH`)."""
    variables, state, _, _, recorded = jax_side
    rng = np.random.default_rng(2)
    fm1 = rng.uniform(0, 6, (2, 6, 8, 576)).astype(np.float32)
    fm2 = rng.normal(0, 1, (2, 3, 4, 320)).astype(np.float32)
    skip = rng.uniform(0, 6, (2, 24, 32, 144)).astype(np.float32)
    inputs_jax, inputs_port = [], []
    conv_int8, pointwise_int8 = tpu_fused._conv_int8, port_fused._pointwise_int8
    monkeypatch.setattr(tpu_fused, "_conv_int8", lambda x, kq, ws, x_scale, b: (
        inputs_jax.append(np.asarray(x)), conv_int8(x, kq, ws, x_scale, b))[1])
    monkeypatch.setattr(port_fused, "_pointwise_int8", lambda x, tables: (
        inputs_port.append(x.permute(0, 2, 3, 1)), pointwise_int8(x, tables))[1])
    want = tpu_fused.heads_forward_folded(
        SMALL_CFG, tpu_fused.fold_heads(variables, SMALL_CFG), jnp.asarray(fm1),
        jnp.asarray(fm2), jnp.asarray(skip), quant=_jax_quant(variables, recorded))
    operands = port_fused.fused_operands(PORT_CFG, state, torch.float32, "cpu")
    tables = _port_tables(state, recorded)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    got = port_fused.heads_forward_folded(PORT_CFG, operands, nchw(fm1), nchw(fm2), nchw(skip),
                                          quant=tables)
    levels = [[port_op.quantize_activations(torch.as_tensor(x), tables[name][1]).numpy()
               for x in (theirs, ours)]
              for name, theirs, ours in zip(TARGETS, inputs_jax, inputs_port)]
    np.testing.assert_array_equal(*levels[0])  # ASPP: the same input, the same levels
    np.testing.assert_allclose(inputs_port[1].numpy(), inputs_jax[1], rtol=1e-5, atol=1e-5)
    flips = np.argwhere(levels[1][0] != levels[1][1])
    assert len(flips) <= DECODER_FLIPS
    assert np.abs(levels[1][0].astype(int) - levels[1][1]).max() <= 1
    reach = np.zeros(got["output-mask"].shape[:3], bool)  # full size: 4x os4
    for b, i, j, _ in flips:
        reach[b, max(4 * (i - FLIP_REACH), 0):4 * (i + FLIP_REACH + 1),
              max(4 * (j - FLIP_REACH), 0):4 * (j + FLIP_REACH + 1)] = True
    mask, mask_want = got["output-mask"].numpy(), np.asarray(want["output-mask"])
    np.testing.assert_allclose(mask[~reach], mask_want[~reach], rtol=1e-5, atol=1e-5)
    assert np.abs(mask[reach] - mask_want[reach]).max(initial=0.0) <= INT8_MASK_BOUND
    for key in ("output-labels", "output-boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_collect_amax_returns_the_inputs_maxima(jax_side):
    _, state, *_ = jax_side
    operands = port_fused.fused_operands(PORT_CFG, state, torch.float32, "cpu")
    rng = np.random.default_rng(4)
    fm1 = torch.from_numpy(rng.uniform(-3, 5, (1, 576, 6, 8)).astype(np.float32))
    fm2 = torch.from_numpy(rng.normal(0, 1, (1, 320, 3, 4)).astype(np.float32))
    skip = torch.from_numpy(rng.uniform(0, 6, (1, 144, 24, 32)).astype(np.float32))
    out, amaxes = port_fused.heads_forward_folded(PORT_CFG, operands, fm1, fm2, skip,
                                                  collect_amax=True)
    assert set(amaxes) == set(TARGETS)
    assert float(amaxes["mask-encoder/aspp-pointwise"]) == float(fm1.abs().max())
    plain = port_fused.heads_forward_folded(PORT_CFG, operands, fm1, fm2, skip)
    for key in plain:
        assert torch.equal(out[key], plain[key]), key


# -- (e) the quantized forward ------------------------------------------------


@pytest.fixture(scope="module")
def quantized(jax_side):
    _, state, x, *_ = jax_side
    return port_fused.make_fused_forward(PORT_CFG, state, torch.float32, device="cpu",
                                         quantize_pointwise=True, calibration_images=x)


def test_quantized_forward_matches_jax_quantized_forward(jax_side, quantized):
    x, expected = jax_side[2:4]
    _compare(expected, quantized(torch.from_numpy(x)), 2e-3)  # the unquantized test's bound


def test_quantized_forward_keeps_the_detection_heads(jax_side, quantized):
    """Labels and boxes do not pass through the quantized convs: the same
    bits as the unquantized forward; the mask within the JAX package's
    int8 bounds of it (0.05 absolute, 5e-3 mean)."""
    _, state, x, *_ = jax_side
    plain = port_fused.make_fused_forward(PORT_CFG, state, torch.float32, device="cpu")
    xt = torch.from_numpy(x)
    got, want = quantized(xt), plain(xt)
    for key in ("output-labels", "output-boxes"):
        assert torch.equal(got[key], want[key]), key
    diff = (got["output-mask"] - want["output-mask"]).abs()
    assert float(diff.max()) <= 0.05 and float(diff.mean()) < 5e-3
    assert float(diff.max()) > 0.0  # the int8 convs ran


# -- (f) the errors -----------------------------------------------------------


def test_make_fused_forward_errors(jax_side):
    _, state, x, *_ = jax_side
    with pytest.raises(ValueError, match="calibration_images"):
        port_fused.make_fused_forward(PORT_CFG, state, device="cpu", quantize_pointwise=True)
    with pytest.raises(ValueError, match="fused_heads=True"):
        port_fused.make_fused_forward(PORT_CFG, state, device="cpu", quantize_pointwise=True,
                                      calibration_images=x, fused_heads=False)


# -- the builder: keywords, errors, a quantized bundle ------------------------


def _builder():
    rng = np.random.default_rng(0)
    n = (6 * 8 + 3 * 4 + 2 * 2 + 1 * 1) * 6  # anchors at 96x128
    return port_builder.MobileNetV2SsdSegBuilder(
        input_image_shape=(96, 128, 3), number_of_boxes_per_point=6, number_of_classes=4,
        center_x_boxes_default=rng.uniform(0, 128, n).astype(np.float32),
        center_y_boxes_default=rng.uniform(0, 96, n).astype(np.float32),
        width_boxes_default=rng.uniform(5, 40, n).astype(np.float32),
        height_boxes_default=rng.uniform(5, 40, n).astype(np.float32),
        standard_deviations_centroids_offsets=(0.1, 0.1, 0.2, 0.2))


NMS = dict(max_number_of_boxes_per_class=4, max_number_of_boxes_per_sample=10,
           boxes_iou_threshold=0.5, labels_probability_threshold=0.26,
           suppress_background_boxes=False, use_segmentation_suppression=True)


@pytest.fixture(scope="module")
def served(jax_side):
    """The builder's quantized f32 serving of the bridged weights."""
    _, state, x, *_ = jax_side
    builder = _builder()
    builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12), device="cpu")
    infer = builder.get_model_for_inference(
        model_trained=state, fused_backbone=True, quantize_pointwise=True,
        calibration_images=x.astype(np.uint8), device="cpu", **NMS)
    return builder, state, infer


def test_every_jax_keyword_of_get_model_for_inference_is_the_port_s():
    def keywords(fn):
        return set(inspect.signature(fn).parameters) - {"self"}

    theirs = keywords(tpu_builder._BuilderBase.get_model_for_inference)
    ours = keywords(port_builder._BuilderBase.get_model_for_inference)
    assert theirs - ours == set()
    # the port's additions: the device, and make_fused_forward's stem route
    assert ours - theirs == {"device", "s2d_stem"}


def test_builder_refuses_quantization_without_the_fused_backbone(served):
    builder, state, _ = served
    with pytest.raises(ValueError, match="fused_backbone=True"):
        builder.get_model_for_inference(model_trained=state, quantize_pointwise=True,
                                        calibration_images=np.zeros((1, 96, 128, 3), np.uint8),
                                        device="cpu", **NMS)


@pytest.mark.parametrize("layout, match", [("tiled", "'default' or 'auto'"),
                                           ("auto", "single-device")])
def test_builder_validates_input_layout_as_jax_does(served, layout, match):
    builder, state, _ = served
    with pytest.raises(ValueError, match=match):
        builder.get_model_for_inference(model_trained=state, input_layout=layout,
                                        mesh=object() if layout == "auto" else None,
                                        device="cpu", **NMS)


def test_input_layout_auto_serves_the_default_program(served):
    builder, state, _ = served
    x = images(9, (2, 96, 128, 3), np.uint8)
    auto, default = (builder.get_model_for_inference(
        model_trained=state, compute_dtype="bfloat16", fused_backbone=True,
        input_layout=layout, input_layout_batch=2, device="cpu", **NMS)
        for layout in ("auto", "default"))
    for a, b in zip(auto(x), default(x)):
        assert torch.equal(a, b)


def test_quantized_bundle_roundtrip_bit_exact(served, tmp_path):
    """(h): a quantized model's b2 bundle reloads and serves the live bits,
    with the op twice in the exported graph and the tables in operands.pt."""
    infer = served[2]
    path = str(tmp_path / "bundle")
    infer.export_serving_bundle(path, batch=2)
    bundle = load_serving_bundle(path)
    assert bundle.metadata["quantize_pointwise"] is True
    graph = torch.export.load(f"{path}/program.pt2").graph
    ops = [str(n.target) for n in graph.nodes if str(n.target).startswith("ssdseglib.")]
    assert ops.count("ssdseglib.int8_pointwise.default") == 2
    assert ops.count("ssdseglib.fused_mbconv.default") == 10
    stored = torch.load(f"{path}/operands.pt", weights_only=True)["network"]
    for name in TARGETS:
        assert stored[name + port_fused.INT8_SUFFIX][0].dtype == torch.int8
    x = images(8, (2, 96, 128, 3), np.uint8)
    for got, want in zip(bundle(x), infer(x)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_quantized_serving_through_the_facade(served):
    """``ssdseglib_torch.compat`` passes both keywords through."""
    import ssdseglib_torch.compat as compat

    _, state, infer = served
    rng = np.random.default_rng(0)
    n = (6 * 8 + 3 * 4 + 2 * 2 + 1 * 1) * 6
    builder = compat.models.MobileNetV2SsdSegBuilder(
        input_image_shape=(96, 128, 3), number_of_boxes_per_point=6, number_of_classes=4,
        center_x_boxes_default=rng.uniform(0, 128, n).astype(np.float32),
        center_y_boxes_default=rng.uniform(0, 96, n).astype(np.float32),
        width_boxes_default=rng.uniform(5, 40, n).astype(np.float32),
        height_boxes_default=rng.uniform(5, 40, n).astype(np.float32),
        standard_deviations_centroids_offsets=(0.1, 0.1, 0.2, 0.2))
    builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12), device="cpu")
    x = images(7, (2, 96, 128, 3))
    facade = builder.get_model_for_inference(
        state, fused_backbone=True, quantize_pointwise=True,
        calibration_images=x.astype(np.uint8), device="cpu", **NMS)
    probe = images(8, (2, 96, 128, 3), np.uint8)
    for got, want in zip(facade.predict(probe), infer.predict(probe)):
        np.testing.assert_array_equal(got, want)


# -- (g) the op's registration ------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_op_passes_opcheck(dtype):
    rng = np.random.default_rng(7)
    args = (torch.from_numpy(rng.normal(0, 1, (2, 5, 6, 72)).astype(np.float32)).to(dtype),
            torch.from_numpy(rng.integers(-127, 128, (40, 72), dtype=np.int8)),
            torch.tensor(30.0),
            torch.from_numpy(rng.uniform(1e-4, 1e-3, 40).astype(np.float32)),
            torch.from_numpy(rng.normal(0, 1, 40).astype(np.float32)))
    torch.library.opcheck(torch.ops.ssdseglib.int8_pointwise.default, args)


# -- (i) with the fused stem --------------------------------------------------


def test_quantized_option_path_matches_jax(jax_side):
    """``quantize_pointwise`` with ``s2d_stem="cuda"`` (the stem kernel's
    plain version here) against the JAX package's quantized forward with
    its Pallas stem (interpret mode); both calibrate through the plain stem,
    so JAX's recorded amaxes stand in for a second calibration there."""
    variables, state, x, _, recorded = jax_side
    real = tpu_fused.calibrate_pointwise_scales
    tpu_fused.calibrate_pointwise_scales = lambda *args, **kwargs: dict(recorded)
    try:
        forward = tpu_fused.make_fused_forward(
            SMALL_CFG, variables, compute_dtype=jnp.float32, interpret=True,
            s2d_stem="pallas", quantize_pointwise=True, calibration_images=x)
    finally:
        tpu_fused.calibrate_pointwise_scales = real
    probe = images(2, (4, 96, 128, 3))  # the Pallas stem takes batches of 4
    expected = forward(jnp.asarray(probe))
    got = port_fused.make_fused_forward(
        PORT_CFG, state, torch.float32, device="cpu", s2d_stem="cuda",
        quantize_pointwise=True, calibration_images=x)(torch.from_numpy(probe))
    _compare(expected, got, 2e-3)
