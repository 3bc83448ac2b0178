"""Smoke run of the PyTorch port on one NVIDIA GPU: serving and training.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch / CUDA / nvcc versions, whether triton imports, the
   card's name and power limit (there is no CPU path: no card, no run);
2. build: the kernel library from ``ssdseglib_torch/csrc`` with nvcc, one
   compiler per source, started together;
3. fused MBConv kernel vs plain twin at the five MBConv widths of the 480x640
   serving path, batch 16, in bf16 (2 ulps) and f32 (1e-5, TF32 off), with
   the median of 20 CUDA-event timings of each;
4. the two backward kernels (depthwise 3x3 backward, dw + BN + ReLU6 chain
   backward) vs their plain versions, in bf16 and f32, at the training
   path's shape (16, 240, 320, 32) and at two shapes outside the model's
   envelope, (16, 120, 160, 144) and the ragged (4, 15, 20, 960).
   Tolerances: dx 1e-5 in f32 and 2 bf16 ulps (1.6e-2) in bf16, relative
   and absolute; dk, dgamma, dbeta (f32 sums of up to 1.2 M terms taken in
   another order) 1e-4 of the largest reference magnitude.  Timings: median
   of 20 CUDA events of the kernel, of the plain version, of the library
   call (``aten.convolution_backward``) for the depthwise backward and, as
   information, of the ATen autograd route for the chain.  The chain unit's
   forward is compared with the ATen route (conv, ``F.batch_norm``, clamp);
5. whole-path serving parity: the BN-folded serving model (fused kernel)
   against the unfused eval-mode model + post-processing, batch 2, 480x640,
   f32;
6. serving: the flagship configuration (warehouse config, bf16, fused
   backbone, bf16 mask) on 16 uint8 480x640 images, checking that every
   call launches the kernel 10 times, then b16 images/s under bench.py's
   protocol (8 distinct batches, warm-up excluded, 16 steps, median of 3
   rounds, fenced by fetching the detections) and b1 latency;
7. training, full width: `Trainer` on the flagship configuration, 16
   synthetic 480x640 samples encoded on the card.  (a) f32, batch 2: the
   loss (1e-5) and every gradient of one step under the three backward
   routes (ATen, chain kernel, depthwise kernel) agree: per tensor, the
   norm of the difference stays below 5e-2 of the tensor's norm (floored at
   1e-4 of the largest), the f32 noise of this network's backward.  (b) bf16, batch 16: steps on one batch under
   each route; every loss finite, the last below the first, exactly one
   launch per step of the kernel the route names and none of the other.
   (c) the median step time of each route, fenced by fetching the loss, and
   the peak memory.

``python3 chip_smoke.py --profile-train [aten|chain|depthwise ...]`` instead
builds the library and prints where the time of a bf16 b16 train step goes
(torch.profiler, kernel time by name) under the named routes; it prints no
result lines.

Weights are random, drawn from a torch.Generator seeded 0 (serving: with
random BatchNorm statistics so the folding is exercised).  The last two
lines are the kernels' JSON report and ``{"ok": true, "device": {...}}``.
In the report, ``launches`` counts the kernel's launches over its main path
(phase 6 for the MBConv kernel, the route's steps of phase 7b for the other
two), ``max_abs_err`` is the largest kernel-vs-plain difference of its phase
over every shape, dtype and output, and ``ms``, ``plain_ms``, ``library_ms``
and ``bound_ms`` are at the main path's shapes in bf16 at batch 16 (the ten
launches of one forward for the MBConv kernel).  ``bound_ms`` is the larger
of bytes / 3.35 TB/s (every input read once, every output written once) and
operations / the card's peak for the type (989 TFLOP/s bf16, 67 TFLOP/s f32).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# (Cin, H, W, E) of the stride-1 residual repeats at 480x640, and how many
# blocks of one forward have that shape (blocks 2, 4-5, 7-9, 11-12, 14-15)
MBCONV_SHAPES = [(24, 120, 160, 144, 1), (32, 60, 80, 192, 2), (64, 30, 40, 384, 3),
                 (96, 30, 40, 576, 2), (160, 15, 20, 960, 2)]
TOLERANCE = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}  # bf16: 2 ulps
BATCH = 16
# (B, H, W, C): the training path's shape (backbone-block0-depthwise at batch
# 16), then two shapes outside the model's envelope
BACKWARD_SHAPES = [(16, 240, 320, 32), (16, 120, 160, 144), (4, 15, 20, 960)]
SUM_TOLERANCE = 1e-4  # f32 sums of up to 1.2 M terms, relative to the largest
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TRAIN_STEPS = 8
# Routes' f32 gradients, per tensor: |difference| / max(|reference|, 1e-4 of the
# largest tensor norm).  The backward of ~60 stacked train-mode BatchNorms
# cancels heavily, so f32 gradients carry noise of this order whatever the
# route (tests/test_torch_train.py measures 2.8e-2 against an f64 run).
GRADIENT_TOLERANCE = 5e-2


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, flops_per_s: float):
    """(least time in ms, what bounds it) for work that moves ``nbytes``
    through device memory and does ``flops`` operations."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    from ssdseglib_torch.ops._cuda_build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    card = card_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | nvcc: {nvcc} "
        f"| triton imports: {has_triton} | {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"[env] card: {card}")
    return card


def phase_build() -> None:
    from ssdseglib_torch.ops import _cuda_build

    t0 = time.perf_counter()
    _cuda_build.load_library()
    info = _cuda_build.build_info
    log(f"[build] {info.path.name}: nvcc {info.seconds:.2f} s, load "
        f"{time.perf_counter() - t0:.2f} s")
    for line in info.ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")


def phase_kernel_vs_twin():
    from ssdseglib_torch.ops.fused_mbconv import (
        fused_mbconv,
        fused_mbconv_reference,
        kernel_tile,
    )

    gen = torch.Generator().manual_seed(0)
    report = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "bytes": 0.0, "flops": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for cin, h, w, e, repeats in MBCONV_SHAPES:
            def draw(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

            x = draw(BATCH, h, w, cin)
            args = (draw(cin, e, scale=cin ** -0.5), draw(e, scale=0.1),
                    draw(9, e, scale=1 / 3), draw(e, scale=0.1),
                    draw(e, cin, scale=e ** -0.5), draw(cin, scale=0.1))
            got = fused_mbconv(x, *args)
            torch.cuda.synchronize()
            want = fused_mbconv_reference(x, *args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            tol = TOLERANCE[dtype]
            bad = int((err > tol + tol * want.float().abs()).sum())
            max_err = float(err.max())
            ms = cuda_median_ms(lambda: fused_mbconv(x, *args))
            plain_ms = cuda_median_ms(lambda: fused_mbconv_reference(x, *args))
            torch.cuda.synchronize()
            log(f"[kernel] {str(dtype)[6:]:8s} Cin={cin:3d} {h}x{w} E={e:3d} "
                f"tile={kernel_tile(dtype, cin, e)} max_abs_err={max_err:.3g} "
                f"kernel {ms:.4f} ms | twin {plain_ms:.4f} ms")
            if bad:
                raise AssertionError(
                    f"kernel disagrees with its twin at Cin={cin} {h}x{w} E={e} "
                    f"{dtype}: {bad} elements beyond rtol=atol={tol}"
                )
            report["max_abs_err"] = max(report["max_abs_err"], max_err)
            if dtype == torch.bfloat16:  # the serving dtype: one forward's worth
                report["ms"] += repeats * ms
                report["plain_ms"] += repeats * plain_ms
                pixels = BATCH * h * w
                weights = cin * e + 9 * e + e * cin + 2 * e + cin
                report["bytes"] += repeats * 2 * (pixels * 2 * cin + weights)
                report["flops"] += repeats * 2 * pixels * e * (cin + 9 + cin)
    # the 1x1s are matrix products: the peak is the tensor cores' bf16 rate
    report["bound_ms"], report["bound_by"] = bound_ms(
        report.pop("bytes"), report.pop("flops"), PEAK_FLOPS[torch.bfloat16])
    return report


def _check_close(name, got, want, tol, scale_by_max=False):
    """Raises unless |got - want| <= tol * (1 + |want|) elementwise, or, for
    ``scale_by_max``, <= tol * max(1, max |want|).  Returns the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if scale_by_max:
        limit = tol * max(1.0, float(want.abs().max()))
        bad = int((err > limit).sum())
    else:
        bad = int((err > tol + tol * want.abs()).sum())
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {bad} elements beyond tolerance {tol} (max abs error "
            f"{float(err.max()):.3g}, max |reference| {float(want.abs().max()):.3g})"
        )
    return float(err.max())


def phase_backward_kernels_vs_plain():
    """Phase 4.  Returns {"depthwise_backward": report, "chain_backward":
    report} with the timings of the path's shape in bf16."""
    import torch.nn.functional as F

    from ssdseglib_torch.ops import depthwise_backward as dwb
    from ssdseglib_torch.ops import fused_chain_backward as fcb

    gen = torch.Generator().manual_seed(1)
    reports = {name: {"max_abs_err": 0.0} for name in ("depthwise_backward",
                                                       "chain_backward")}
    for dtype in (torch.bfloat16, torch.float32):
        elem = 2 if dtype == torch.bfloat16 else 4
        for shape in BACKWARD_SHAPES:
            b, h, w, c = shape
            n = b * h * w * c

            def draw(*dims, scale=1.0, shift=0.0):
                return (torch.randn(*dims, generator=gen) * scale + shift).to("cuda")

            x = draw(*shape, scale=2.0).to(dtype)
            dy = draw(*shape).to(dtype)
            kernel = draw(3, 3, 1, c, scale=0.5).to(dtype)
            gamma, beta = draw(c, scale=0.1, shift=1.0), draw(c, scale=0.1)
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last views, as in the model
            dy_nchw = dy.permute(0, 3, 1, 2)
            weight = kernel.permute(3, 2, 0, 1).contiguous()
            tag = f"{str(dtype)[6:]:8s} {shape}"

            # -- depthwise 3x3 backward
            dx, dk = dwb.depthwise3x3_backward(x, dy, kernel)
            torch.cuda.synchronize()
            dx_ref, dk_ref = dwb.depthwise3x3_backward_reference(x, dy, kernel)
            errs = [_check_close(f"depthwise backward dx {tag}", dx, dx_ref, TOLERANCE[dtype]),
                    _check_close(f"depthwise backward dk {tag}", dk, dk_ref, SUM_TOLERANCE,
                                 scale_by_max=True)]
            ms = cuda_median_ms(lambda: dwb.depthwise3x3_backward(x, dy, kernel))
            plain_ms = cuda_median_ms(
                lambda: dwb.depthwise3x3_backward_reference(x, dy, kernel))
            library_ms = cuda_median_ms(lambda: torch.ops.aten.convolution_backward(
                dy_nchw, x_nchw, weight, None, [1, 1], [1, 1], [1, 1], False, [0, 0], c,
                [True, True, False]))
            least, by = bound_ms(3 * n * elem + 2 * 9 * c * 4, 36 * n, PEAK_FLOPS[torch.float32])
            log(f"[dw-bwd] {tag} max_abs_err dx {errs[0]:.3g} dk {errs[1]:.3g} | kernel "
                f"{ms:.4f} ms | plain {plain_ms:.4f} ms | aten.convolution_backward "
                f"{library_ms:.4f} ms | bound {least:.4f} ms ({by})")
            rep = reports["depthwise_backward"]
            rep["max_abs_err"] = max(rep["max_abs_err"], *errs)
            if dtype == torch.bfloat16 and shape == BACKWARD_SHAPES[0]:
                rep.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=least, bound_by=by)

            # -- dw + BN + ReLU6 chain backward
            y, u_nchw, mean, var = fcb._forward_math(x_nchw, weight, gamma, beta)
            u = u_nchw.permute(0, 2, 3, 1)
            args = (x, u, dy, kernel, gamma, beta, mean, var)
            got = fcb.dw_bn_relu6_backward(*args)
            torch.cuda.synchronize()
            want = fcb.dw_bn_relu6_backward_reference(*args)
            errs = [_check_close(f"chain backward dx {tag}", got[0], want[0], TOLERANCE[dtype])]
            errs += [_check_close(f"chain backward {name} {tag}", g, r, SUM_TOLERANCE,
                                  scale_by_max=True)
                     for name, g, r in zip(("dk", "dgamma", "dbeta"), got[1:], want[1:])]
            ms = cuda_median_ms(lambda: fcb.dw_bn_relu6_backward(*args))
            plain_ms = cuda_median_ms(lambda: fcb.dw_bn_relu6_backward_reference(*args))

            # the ATen route of the same unit: forward compared, backward timed
            leaves = [t.detach().requires_grad_() for t in (x_nchw, weight, gamma, beta)]
            bn_weight, bn_bias = (leaves[2], leaves[3]) if dtype == torch.float32 else (
                leaves[2].to(dtype), leaves[3].to(dtype))
            y_aten = F.batch_norm(
                F.conv2d(leaves[0], leaves[1], None, 1, 1, 1, c), None, None, bn_weight,
                bn_bias, True, 0.01, fcb.BN_EPSILON).clamp(0.0, 6.0)
            fwd_diff = float((y.float() - y_aten.detach().float()).abs().max())
            fwd_tol = 1e-5 if dtype == torch.float32 else 3.2e-2  # bf16: one ulp at 6
            if fwd_diff > fwd_tol:
                raise AssertionError(
                    f"chain forward differs from the ATen route by {fwd_diff} at {tag}")
            aten_ms = cuda_median_ms(lambda: torch.autograd.grad(
                y_aten, leaves, dy_nchw, retain_graph=True))
            least, by = bound_ms(4 * n * elem + 2 * 9 * c * 4, 56 * n, PEAK_FLOPS[torch.float32])
            log(f"[chain-bwd] {tag} max_abs_err dx {errs[0]:.3g} dk {errs[1]:.3g} dgamma "
                f"{errs[2]:.3g} dbeta {errs[3]:.3g} | kernel {ms:.4f} ms | plain "
                f"{plain_ms:.4f} ms | ATen autograd route {aten_ms:.4f} ms | bound "
                f"{least:.4f} ms ({by}) | forward vs ATen route max diff {fwd_diff:.3g}"
                f"{' (bit for bit)' if fwd_diff == 0.0 else ''}")
            rep = reports["chain_backward"]
            rep["max_abs_err"] = max(rep["max_abs_err"], *errs)
            if dtype == torch.bfloat16 and shape == BACKWARD_SHAPES[0]:
                rep.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=least,
                           bound_by=by)
            del leaves, y_aten, y, u_nchw, u, args, got, want
            torch.cuda.empty_cache()
    return reports


def _builder():
    from ssdseglib_torch.boxes import Anchors
    from ssdseglib_torch.config import reference_warehouse_config
    from ssdseglib_torch.models.builder import MobileNetV2SsdSegBuilder

    anchors_cfg, enc_cfg, model_cfg, nms_cfg, _ = reference_warehouse_config()
    anchors = Anchors.from_config(anchors_cfg, enc_cfg.image_shape)
    builder = MobileNetV2SsdSegBuilder(
        input_image_shape=model_cfg.input_image_shape,
        number_of_boxes_per_point=list(model_cfg.boxes_per_point),
        number_of_classes=model_cfg.number_of_classes,
        center_x_boxes_default=anchors.center_x,
        center_y_boxes_default=anchors.center_y,
        width_boxes_default=anchors.width,
        height_boxes_default=anchors.height,
        standard_deviations_centroids_offsets=enc_cfg.standard_deviations,
    )
    gen = torch.Generator().manual_seed(0)
    model = builder.get_model_for_training(
        segmentation_dilation_rates=model_cfg.segmentation_dilation_rates,
        generator=gen,
    )
    # random BatchNorm statistics and bias, so folding matters and the
    # ReLUs stay alive through the heads
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t in (m.running_mean, m.running_var, m.bias):
                    t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    nms = dict(
        max_number_of_boxes_per_class=nms_cfg.max_boxes_per_class,
        max_number_of_boxes_per_sample=nms_cfg.max_boxes_per_sample,
        boxes_iou_threshold=nms_cfg.iou_threshold,
        labels_probability_threshold=nms_cfg.score_threshold,
        suppress_background_boxes=nms_cfg.suppress_background_boxes,
        use_segmentation_suppression=nms_cfg.use_segmentation_suppression,
    )
    return builder, model.to("cuda"), nms


def _uint8_images(seed: int, batch: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (batch, 480, 640, 3),
                                                dtype=np.uint8)


def phase_whole_path_parity() -> None:
    builder, model, nms = _builder()
    kwargs = dict(model_trained=model, compute_dtype="float32", device="cuda", **nms)
    fused = builder.get_model_for_inference(fused_backbone=True, **kwargs)
    plain = builder.get_model_for_inference(fused_backbone=False, **kwargs)
    # an operating point that keeps rows valid under random weights
    for m in (fused, plain):
        m.set_nms_operating_point(boxes_iou_threshold=0.5,
                                  labels_probability_threshold=0.3)
    x = _uint8_images(1, 2)
    raw_f = [t.cpu().numpy() for t in fused.raw_outputs(x)]
    raw_p = [t.cpu().numpy() for t in plain.raw_outputs(x)]
    for name, a, b in zip(("mask", "labels", "boxes"), raw_f, raw_p):
        diff = float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))
        log(f"[parity] {name} {a.shape}: max |fused - plain| / (1 + |plain|) = {diff:.3g}")
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3, err_msg=name)
    (_, det_f), (_, det_p) = fused.predict(x), plain.predict(x)
    n_valid = int((det_p[..., 1] > 0).sum())
    log(f"[parity] detections {det_f.shape}: {n_valid} valid rows in the plain path")
    assert n_valid > 0, "no valid detection rows to compare"
    np.testing.assert_array_equal(det_f[..., 0], det_p[..., 0])
    np.testing.assert_allclose(det_f[..., 1:], det_p[..., 1:], rtol=2e-3, atol=2e-3)


def phase_serving(card: str):
    from ssdseglib_torch.ops.fused_mbconv import fused_mbconv

    builder, model, nms = _builder()
    infer = builder.get_model_for_inference(
        model_trained=model, compute_dtype="bfloat16", fused_backbone=True,
        mask_output="bfloat16", device="cuda", **nms,
    )
    base = np.random.default_rng(0).uniform(0, 255, (BATCH, 480, 640, 3))
    inputs = [infer.prepare_input(((base + float(i)) % 256.0).astype(np.uint8))
              for i in range(8)]
    single = infer.prepare_input(_uint8_images(2, 1))
    infer(inputs[0])  # warm-up
    infer(single)
    torch.cuda.synchronize()

    fused_mbconv.launches = 0  # the main path starts here
    calls = 1
    mask, det = infer(inputs[0])
    det_host = det.cpu()
    assert fused_mbconv.launches == 10, fused_mbconv.launches
    assert tuple(mask.shape) == (BATCH, 480, 640, 4) and mask.dtype == torch.bfloat16
    assert tuple(det_host.shape) == (BATCH, 10, 6) and det_host.dtype == torch.float32
    assert bool(torch.isfinite(mask).all()) and bool(torch.isfinite(det_host).all())
    sum_err = float((mask.float().sum(-1) - 1.0).abs().max())
    assert sum_err < 1e-2, f"mask probabilities sum to 1 +- {sum_err}"
    log(f"[serve] b16 outputs: mask {tuple(mask.shape)} {mask.dtype}, detections "
        f"{tuple(det_host.shape)}, |sum(mask) - 1| <= {sum_err:.3g}, "
        f"{int((det_host[..., 1] > 0).sum())} valid rows")

    steps, rates = 16, []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [infer(inputs[i % len(inputs)]) for i in range(steps)]
        outs[-1][1].cpu()  # fence: fetch the last step's detections
        rates.append(steps * BATCH / (time.perf_counter() - t0))
        calls += steps
    latencies = []
    for _ in range(20):
        t0 = time.perf_counter()
        infer(single)[1].cpu()
        latencies.append((time.perf_counter() - t0) * 1e3)
        calls += 1
    launches = fused_mbconv.launches
    assert launches == 10 * calls, (launches, calls)
    log(f"[serve] b16 images/s, rounds: {[round(r, 2) for r in rates]}")
    log(f"[serve] joint_inference_throughput_b16_480x640 {statistics.median(rates):.2f} "
        f"images/s | b1 latency {statistics.median(latencies):.3f} ms (median of 20, "
        f"fetch-fenced) | {card} | peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _train_batch(batch: int):
    """``batch`` synthetic 480x640 samples: images and one-hot masks as
    tensors on the card, detection targets encoded on the card."""
    from ssdseglib_torch.boxes import Anchors
    from ssdseglib_torch.config import reference_warehouse_config
    from ssdseglib_torch.data.synthetic import generate_dataset
    from ssdseglib_torch.ops.encoding import make_batch_encoder

    anchors_cfg, enc_cfg, model_cfg, _, _ = reference_warehouse_config()
    anchors = Anchors.from_config(anchors_cfg, enc_cfg.image_shape)
    samples = generate_dataset(batch, image_shape=enc_cfg.image_shape,
                               num_classes=enc_cfg.num_classes, seed=0)
    g = enc_cfg.max_ground_truth_boxes
    labels = np.zeros((batch, g), np.int32)
    boxes = np.zeros((batch, g, 4), np.float32)
    valid = np.zeros((batch, g), bool)
    for i, s in enumerate(samples):
        n = min(len(s.labels), g)
        labels[i, :n], boxes[i, :n], valid[i, :n] = s.labels[:n], s.boxes[:n], True
    enc_labels, enc_boxes = make_batch_encoder(anchors, enc_cfg, device="cuda")(
        labels, boxes, valid)
    positives = int((enc_labels[..., 0] == 0).sum())
    assert tuple(enc_labels.shape) == (batch, 9600, 4) and positives > 0
    images = torch.from_numpy(np.stack([s.image for s in samples])).to("cuda").float()
    masks = torch.nn.functional.one_hot(
        torch.from_numpy(np.stack([s.mask for s in samples])).to("cuda").long(),
        enc_cfg.num_classes).float()
    targets = {"output-mask": masks, "output-labels": enc_labels, "output-boxes": enc_boxes}
    return anchors, model_cfg, images, targets, positives


ROUTES = {  # name -> (chain gate, depthwise gate)
    "aten": ("aten", "aten"), "chain": ("cuda", "aten"), "depthwise": ("aten", "cuda")}


def _set_route(name: str) -> None:
    from ssdseglib_torch.models import blocks

    chain_gate, depthwise_gate = ROUTES[name]
    blocks.set_chain_bwd_impl(chain_gate)
    blocks.set_depthwise_bwd_impl(depthwise_gate)


def phase_training(card: str):
    """Phase 7.  Returns {"chain": launches, "depthwise": launches} counted
    over the bf16 b16 steps of the route that names the kernel."""
    from ssdseglib_torch.config import TrainConfig
    from ssdseglib_torch.models.builder import SsdSegModel
    from ssdseglib_torch.ops import depthwise_backward as dwb
    from ssdseglib_torch.ops import fused_chain_backward as fcb
    from ssdseglib_torch.train import Trainer

    counters = {"chain": fcb.dw_bn_relu6_backward, "depthwise": dwb.depthwise3x3_backward}
    anchors, model_cfg, images, targets, positives = _train_batch(BATCH)
    log(f"[train] batch: images {tuple(images.shape)}, {positives} positive anchors of "
        f"{BATCH * 9600}, encoded on the card")
    model = SsdSegModel(model_cfg, torch.Generator().manual_seed(0))
    try:
        # (a) f32, batch 2: the loss and every gradient of one step, three routes
        trainer = Trainer(model=model, anchors=anchors,
                          config=TrainConfig(batch_size=2, compute_dtype="float32"))
        small = images[:2], {k: v[:2] for k, v in targets.items()}
        results = {}
        for route in ROUTES:
            _set_route(route)
            state = trainer.init_state(torch.Generator().manual_seed(0))
            metrics, grads, _ = trainer.loss_and_grads(state, *small)
            results[route] = float(metrics["loss"]), grads
        loss_ref, grads_ref = results["aten"]
        floor = 1e-4 * max(float(torch.linalg.vector_norm(g)) for g in grads_ref.values())
        for route in ("chain", "depthwise"):
            loss, grads = results[route]
            worst = max(
                float(torch.linalg.vector_norm(grads[k] - grads_ref[k])
                      / torch.linalg.vector_norm(grads_ref[k]).clamp_min(floor))
                for k in grads_ref)
            log(f"[train] f32 b2 route {route}: loss {loss:.6f} vs ATen {loss_ref:.6f}; "
                f"largest relative gradient difference of a tensor {worst:.3g} "
                f"({len(grads_ref)} tensors)")
            assert abs(loss - loss_ref) <= 1e-5 * abs(loss_ref), (route, loss, loss_ref)
            assert worst <= GRADIENT_TOLERANCE, (route, worst)
        del results, grads_ref, trainer, state, grads

        # (b), (c) bf16, batch 16: steps on one batch under each route
        trainer = Trainer(model=model, anchors=anchors,
                          config=TrainConfig(batch_size=BATCH, compute_dtype="bfloat16"))
        launches, report = {}, {}
        for route in ROUTES:
            _set_route(route)
            state = trainer.init_state(torch.Generator().manual_seed(0))
            trainer.train_step(state, images, targets)[1]["loss"].item()  # warm-up
            state = trainer.init_state(torch.Generator().manual_seed(0))
            for counter in counters.values():
                counter.launches = 0
            fcb.dw_bn_relu6_chain.copies = dwb.depthwise_conv3x3_fused_bwd.copies = 0
            torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                _, metrics = trainer.train_step(state, images, targets)
                losses.append(metrics["loss"].item())  # the fence
                times.append((time.perf_counter() - t0) * 1e3)
            counts = {name: counter.launches for name, counter in counters.items()}
            copies = fcb.dw_bn_relu6_chain.copies + dwb.depthwise_conv3x3_fused_bwd.copies
            for name, count in counts.items():
                assert count == (TRAIN_STEPS if name == route else 0), (route, counts)
            assert copies == 0, f"route {route}: {copies} hidden layout copies"
            assert all(np.isfinite(losses)), (route, losses)
            assert losses[-1] < losses[0], (route, losses)
            assert state.step == TRAIN_STEPS
            launches[route] = counts.get(route, 0)
            report[route] = statistics.median(times)
            log(f"[train] bf16 b16 route {route}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
                f"over {TRAIN_STEPS} steps, kernel launches {counts}, step "
                f"{report[route]:.3f} ms (median, fetch-fenced), "
                f"{BATCH / report[route] * 1e3:.2f} images/s, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
        return launches
    finally:
        _set_route("aten")


def profile_training(card: str, route: str, steps: int = 6) -> None:
    """``python3 chip_smoke.py --profile-train [route]``: where the time of
    one bf16 b16 train step goes, from torch.profiler over ``steps`` steps
    (kernel events only; the profiler adds host time, so the wall time here
    is above the unprofiled step time of phase 7)."""
    from torch.profiler import ProfilerActivity, profile

    from ssdseglib_torch.config import TrainConfig
    from ssdseglib_torch.models.builder import SsdSegModel
    from ssdseglib_torch.train import Trainer

    anchors, model_cfg, images, targets, _ = _train_batch(BATCH)
    trainer = Trainer(model=SsdSegModel(model_cfg, torch.Generator().manual_seed(0)),
                      anchors=anchors,
                      config=TrainConfig(batch_size=BATCH, compute_dtype="bfloat16"))
    _set_route(route)
    try:
        state = trainer.init_state(torch.Generator().manual_seed(0))
        for _ in range(3):
            trainer.train_step(state, images, targets)[1]["loss"].item()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.train_step(state, images, targets)[1]["loss"].item()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        _set_route("aten")
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels.sort(key=lambda row: -row[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    log(f"[profile] route {route}: wall {wall_ms:.3f} ms/step (profiled), device kernel time "
        f"{device_ms:.3f} ms/step, busy share {device_ms / wall_ms:.3f}, "
        f"{sum(n for _, _, n in kernels):.1f} kernels/step | {card}")
    own = ("chain_bwd_kernel", "chain_sums_kernel", "dw_bwd_kernel", "reduce_partials_kernel")
    for rank, (name, ms, count) in enumerate(kernels):
        if rank < 25 or any(k in name for k in own):  # the top, and the port's own kernels
            log(f"[profile] {ms:8.3f} ms {100 * ms / device_ms:5.1f}% x{count:6.1f}  {name[:110]}")


def main() -> None:
    card = phase_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if "--profile-train" in sys.argv:
        routes = [a for a in sys.argv[1:] if a in ROUTES] or list(ROUTES)
        for route in routes:
            profile_training(card, route)
        return
    mbconv = phase_kernel_vs_twin()
    backward = phase_backward_kernels_vs_plain()
    phase_whole_path_parity()
    mbconv["launches"] = phase_serving(card)
    train_launches = phase_training(card)
    backward["depthwise_backward"]["launches"] = train_launches["depthwise"]
    backward["chain_backward"]["launches"] = train_launches["chain"]
    described = {
        "fused_mbconv": ("ssdseglib_torch/csrc/fused_mbconv.cu",
                         "ssdseglib_tpu/ops/fused_mbconv.py:48", mbconv),
        "depthwise_backward": ("ssdseglib_torch/csrc/depthwise_backward.cu",
                               "ssdseglib_tpu/ops/depthwise_backward.py:80",
                               backward["depthwise_backward"]),
        "chain_backward": ("ssdseglib_torch/csrc/fused_chain_backward.cu",
                           "ssdseglib_tpu/ops/fused_chain_backward.py:79",
                           backward["chain_backward"]),
    }
    for name, (_, _, report) in described.items():
        if report["launches"] < 1:
            raise AssertionError(f"the main path never launched {name}")
    print(card)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": report["launches"],
        "max_abs_err": report["max_abs_err"],
        "ms": report["ms"],
        "plain_ms": report["plain_ms"],
        "bound_ms": report["bound_ms"],
        "bound_by": report["bound_by"],
        "library_ms": report.get("library_ms"),
    } for name, (source, replaces, report) in described.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
