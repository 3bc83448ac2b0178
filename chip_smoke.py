"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch / CUDA / nvcc versions, whether triton imports, the
   card's name and power limit (there is no CPU path: no card, no run);
2. build: the fused MBConv kernel from ``ssdseglib_torch/csrc`` with nvcc;
3. kernel vs plain twin at the five MBConv widths of the 480x640 serving
   path, batch 16, in bf16 (2 ulps) and f32 (1e-5, TF32 off), with the
   median of 20 CUDA-event timings of each;
4. whole-path parity: the BN-folded serving model (fused kernel) against
   the unfused eval-mode model + post-processing, batch 2, 480x640, f32;
5. serving: the flagship configuration (warehouse config, bf16, fused
   backbone, bf16 mask) on 16 uint8 480x640 images, checking that every
   call launches the kernel 10 times, then b16 images/s under bench.py's
   protocol (8 distinct batches, warm-up excluded, 32 steps, median of 3
   rounds, fenced by fetching the detections) and b1 latency.

Weights are random, drawn from a torch.Generator seeded 0, with random
BatchNorm statistics so the folding is exercised.  The last two lines are
the kernels' JSON report and ``{"ok": true, "device": {...}}``.  In the
report, ``ms`` and ``plain_ms`` are one bf16 b16 forward's ten launches
(the phase-3 medians times the blocks of each shape), ``max_abs_err`` the
largest kernel-vs-twin difference of phase 3 (both dtypes), and
``launches`` the kernel launches counted over phase 5.
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
    report = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
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
    return report


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

    steps, rates = 32, []
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


def main() -> None:
    card = phase_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kernel = phase_kernel_vs_twin()
    phase_whole_path_parity()
    launches = phase_serving(card)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "fused_mbconv",
        "route": "cuda",
        "source": "ssdseglib_torch/csrc/fused_mbconv.cu",
        "replaces": "ssdseglib_tpu/ops/fused_mbconv.py:48",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
