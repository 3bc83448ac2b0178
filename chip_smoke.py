"""Smoke run of the PyTorch port on one NVIDIA GPU: serving and training.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch / CUDA / nvcc versions, whether triton imports, the
   card's name and power limit (there is no CPU path: no card, no run);
2. build: the kernel library from ``ssdseglib_torch/csrc`` with nvcc, one
   compiler per source, started together;
3. fused MBConv kernel vs plain twin at the five MBConv widths of the 480x640
   serving path, batch 16, in bf16 (2 ulps; the E-chunked tensor-core
   kernel) and f32 (1e-5, TF32 off; the CUDA-core kernel), with each width's
   tile, chunk of E, threads and shared memory, the median of 20 CUDA-event
   timings of each and, as information, of the same block run as the
   unfused default sequence (three cuDNN convs with their bias and ReLU6
   passes, and the residual add);
   3b. the NMS scan kernel vs its plain version: (16, 4, 256) candidates
   from the decoded boxes of the flagship model, plus synthetic (2, 2, 100),
   (1, 1, 1) and (3, 4, 1024); Python-float and 0-d-tensor thresholds; the
   keep masks must be equal; median of 20 CUDA-event timings of each at
   (16, 4, 256);
   3c. the fused stem + block 1 kernel vs its plain version at
   (16, 480, 640, 3) and the ragged (3, 36, 52, 3), in bf16 and f32 (1e-5,
   TF32 off).  bf16 is held at 1.6e-2 of 1 + |twin| (2 ulps at 1) to the
   plain version that sums in the kernel's tensor-core order
   (``k_groups=True``: 16-deep steps, each step's exact sum rounded toward
   zero), and its ulp histograms against that twin and the JAX-order one
   are printed.  Timings at (16, 480, 640, 3) in bf16 of the wrapper, the
   kernel alone (20 launches between two CUDA events), the plain version
   and, as information, the six cuDNN convs (with their bias and clamp
   passes) that the default path runs for the same function;
4. the two backward kernels (depthwise 3x3 backward, dw + BN + ReLU6 chain
   backward) vs their plain versions, in bf16 and f32, at the training
   path's shape (16, 240, 320, 32) and at two shapes outside the model's
   envelope, (16, 120, 160, 144) and the ragged (4, 15, 20, 960); the chain
   also at (4, 60, 80, 12), a C that is not a multiple of 8.  The chain is
   called as its autograd unit calls it (the forward's coefficients, the
   weight's view) and must give the same bits on two calls; that one call
   issues exactly two device kernels is counted in phase 4b.
   Tolerances: dx 1e-5 in f32 and 2 bf16 ulps (1.6e-2) in bf16, relative
   and absolute; dk, dgamma, dbeta (f32 sums of up to 1.2 M terms taken in
   another order) 1e-4 of the largest reference magnitude.  Timings: median
   of 20 CUDA events of the kernel (for the chain: the wrapper, and its two
   launches alone, 20 calls between two events), of the plain version, of
   the library call (``aten.convolution_backward``) for the depthwise
   backward and, as information, of the ATen autograd route for the chain.
   The chain's bound counts 6 n elem bytes: pass 1 reads u and dy, pass 2
   reads x, u, dy and writes dx (dbeta and dgamma are needed before any du,
   and u and dy do not stay in the 50 MB L2 between the passes).  The chain
   unit's forward is compared with the ATen route (conv, ``F.batch_norm``,
   clamp);
   4b. the three 1x1 weight-gradient kernels (tensor-core product, CUDA-core
   product, loads alone) vs their plain versions at the training path's two
   layers, (16, 240, 320, 32 -> 16) and (16, 240, 320, 16 -> 96), at the same
   two at batch 2 and at the ragged (3, 37, 53, 48 -> 32), in bf16 (all three)
   and f32 (CUDA-core product, loads alone): f32 sums of up to 1.2 M terms
   within 1e-4 of the largest reference magnitude.  Timings: kernel, plain
   version and the library call (``aten.convolution_backward``, weight
   only, timed before and after the kernels).  Then `wgrad_study` at
   (16, 240, 320, 32 -> 16) bf16: the tensor-core kernel within 2e-2
   (relative to the largest magnitude) of the f32 product, and the five
   routes timed by CUDA events; one device kernel and one allocation (the
   returned gradient) per `wgrad_mma` call after the first, and two device
   kernels and nothing else per chain backward call at its path's shape
   (with each one's device time), from the process's one torch.profiler
   session; the three kernels alone at the two layers;
5. whole-path serving parity: the BN-folded serving model (fused kernel)
   against the unfused eval-mode model + post-processing, batch 2, 480x640,
   f32;
6. serving: the flagship configuration (warehouse config, bf16, fused
   backbone, bf16 mask) on 16 uint8 480x640 images, checking that every
   call launches the kernel 10 times, then b16 images/s under bench.py's
   protocol (8 distinct batches, warm-up excluded, 16 steps, median of 3
   rounds, fenced by fetching the detections) and b1 latency; last, the raw
   outputs against the same path with the kernel's plain version in its
   place (SERVE_PLAIN_TOLERANCE);
7. training, full width: `Trainer` on the flagship configuration, 16
   synthetic 480x640 samples encoded on the card.  (a) f32, batch 2: the
   loss (1e-5) and every gradient of one step under the three backward
   routes (ATen, chain kernel, depthwise kernel) agree: per tensor, the
   norm of the difference stays below 5e-2 of the tensor's norm (floored at
   1e-4 of the largest), the f32 noise of this network's backward.  (b) bf16,
   batch 16: steps on one batch under each route; every loss finite, the
   last below the first, exactly one launch per step of the kernel the route
   names and none of the other.
   (c) the median step time of each route, fenced by fetching the loss, and
   the peak memory.
8. the option path, full width: `make_fused_forward(..., s2d_stem="cuda")`
   -> suppression -> decode -> `combined_nms(..., method="topk")` on the
   flagship configuration.  (a) f32, batch 2: the three outputs against the
   default path's (`s2d_stem=False`) within 2e-3, and ``method="topk"``
   against ``method="exact"`` at an operating point where the script has
   counted at most 256 candidates per class: labels equal, scores and boxes
   2e-3, at least one valid row.  (b) bf16, batch 16: one call launches the
   stem kernel once, the scan kernel once and the MBConv kernel 10 times;
   outputs finite, (16, 480, 640, 4) and (16, 10, 6).  (c) images/s of this
   path under phase 6's protocol, and the post-processing alone (suppression
   + decode + NMS, CUDA events) under ``exact`` and under ``topk`` at batch
   16 and batch 1.

9. a whole training run, full width: 32 synthetic 480x640 samples ->
   `TrainDataLoader` (batch 16, flip and rgb augmentation, transform on the
   card) -> `Trainer(compute_dtype="bfloat16").fit(epochs=2,
   checkpointer=Checkpointer(tmp))` under ``set_wgrad_impl('cuda')``: the
   tensor-core kernel launched once per step for every layer of the model
   inside the envelope (counted from the model), no layout copies, every
   epoch loss finite and the last below the first; a second `Trainer`
   resumes from the checkpoint (state equal bit for bit, step restored) and
   trains one more epoch; the evaluators (`average_precision_object_detection`,
   `jaccard_iou_semantic_segmentation`) run on the trained model's
   predictions.  (a) f32, batch 2: loss (1e-5) and gradients (phase 7a's
   metric) of one step under the gates 'aten', 'dot', 'cuda'.  (b) bf16,
   batch 16: step time under the three gates in turns (aten, dot, cuda, then
   back), fenced by the loss, and the images/s of a `fit` epoch over the
   loader (no checkpoint in the timing), at the run's 2 steps and at 8 steps
   an epoch.

``python3 chip_smoke.py --profile-train [aten|chain|depthwise|wgrad-dot|wgrad-cuda ...]`` instead
builds the library and prints where the time of a bf16 b16 train step goes
(torch.profiler, kernel time by name) under the named routes, and
``python3 chip_smoke.py --profile-serve`` where the device time of a bf16 b16
serving step goes on the default path and on the option path, and
``python3 chip_smoke.py --profile-fit`` what each stage of a `fit` epoch over
the loader costs alone, and
``python3 chip_smoke.py --wgrad-variants`` times the three weight-gradient
kernels alone, the tensor-core one at other (rows per slab, CTAs), and
``python3 chip_smoke.py --mbconv-variants`` the bf16 MBConv kernel at other
(tile, chunk of E, column tiles per warp), ``python3 chip_smoke.py
--stem-variants`` the bf16 stem kernel at other (tile, chunk of block 1's
channels, warps), ``python3 chip_smoke.py
--chain-variants`` the chain backward at other (tile rows, tile columns),
all through the launchers' runtime arguments, and
``python3 chip_smoke.py --ab PARENT_ROOT`` the stem and chain kernels of an
unpacked parent tree and of this one in turns (parent, change, change,
parent; one process each); none of these prints result lines.

Weights are random, drawn from a torch.Generator seeded 0 (serving: with
random BatchNorm statistics so the folding is exercised).  The last two
lines are the kernels' JSON report and ``{"ok": true, "device": {...}}``.
In the report, ``launches`` counts the kernel's launches over its main path
(phase 6 for the MBConv kernel, the route's steps of phase 7b for the two
backward kernels, phase 8b-c for the scan and stem kernels, the `fit` of
phase 9 for the tensor-core weight-gradient kernel, the f32 step of phase 9a
for the CUDA-core one, `wgrad_study` of phase 4b for the loads-alone kernel),
``max_abs_err``
is the largest kernel-vs-plain difference of its phase over every shape,
dtype and output, and ``ms``, ``plain_ms``, ``library_ms``
and ``bound_ms`` are at the main path's shapes in bf16 at batch 16 (the ten
launches of one forward for the MBConv kernel, whose bound counts its 1x1s
at the tensor cores' rate and its depthwise taps at the f32 rate; the two launches of one train
step for the tensor-core weight-gradient kernel; f32 at batch 2, the two
launches of phase 9a's step, for the CUDA-core one).  ``library_ms`` of the
loads-alone kernel is the library's weight gradient, whose loads it
reproduces.  ``bound_ms`` is the larger
of bytes / 3.35 TB/s (every input read once, every output written once) and
operations / the card's peak for the type (989 TFLOP/s bf16 for matrix
products, 67 TFLOP/s f32 for stencils and compares).  The scan's bound
ignores the latency of its dependent steps.
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
# the chain kernels also at a C that is not a multiple of 8 (their scalar
# path in bf16; a ragged channel chunk in f32)
CHAIN_SHAPES = BACKWARD_SHAPES + [(4, 60, 80, 12)]
# The previous design's figures at the training path's shape (PERF.md §6: the
# two-pass chain kernels with their reduction launches and the PyTorch
# operations between them), printed beside this run's for reference
CHAIN_PARENT = ("wrapper 0.594-0.705 ms, bound 0.094 ms as then counted (4 n elem bytes), "
                "NVIDIA H100 80GB HBM3, 700 W")
SUM_TOLERANCE = 1e-4  # f32 sums of up to 1.2 M terms, relative to the largest
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TRAIN_STEPS = 8
# an operating point that keeps rows valid under random weights
IOU_THRESHOLD, SCORE_THRESHOLD = 0.5, 0.3
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


def bound_ms(nbytes: float, *work):
    """(least time in ms, what bounds it) for work that moves ``nbytes``
    through device memory and does ``work``: (operations, peak rate) pairs,
    one per type of operation."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = sum(flops / rate for flops, rate in work) * 1e3
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


def _mbconv_sequence(x, w1, b1, wd, b2, w3, b3):
    """The block as the unfused default path would run it: three cuDNN convs
    (expand, depthwise, project) with their bias and ReLU6 passes, and the
    residual add, on the channels-last NCHW view of NHWC ``x``."""
    from ssdseglib_torch.models.fused_inference import _conv

    e, cin, cout = w1.shape[1], w1.shape[0], w3.shape[1]
    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2)
    y = _conv(xc, w1.t().reshape(e, cin, 1, 1).contiguous(memory_format=cl), b1, relu6=True)
    y = _conv(y, wd.t().reshape(e, 1, 3, 3).contiguous(memory_format=cl), b2, depthwise=True,
              relu6=True)
    y = _conv(y, w3.t().reshape(cout, e, 1, 1).contiguous(memory_format=cl), b3)
    return (y + xc).permute(0, 2, 3, 1)


def _mbconv_operands(gen, dtype, cin, h, w, e, batch=BATCH):
    def draw(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    x = draw(batch, h, w, cin)
    args = (draw(cin, e, scale=cin ** -0.5), draw(e, scale=0.1),
            draw(9, e, scale=1 / 3), draw(e, scale=0.1),
            draw(e, cin, scale=e ** -0.5), draw(cin, scale=0.1))
    return x, args


def phase_kernel_vs_twin():
    from ssdseglib_torch.ops.fused_mbconv import (
        fused_mbconv,
        fused_mbconv_reference,
        kernel_tile,
    )

    gen = torch.Generator().manual_seed(0)
    report = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "bytes": 0.0, "products": 0.0,
              "taps": 0.0}
    sequence_ms = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for cin, h, w, e, repeats in MBCONV_SHAPES:
            x, args = _mbconv_operands(gen, dtype, cin, h, w, e)
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
            th, tw, ec, threads, smem = kernel_tile(dtype, cin, e, cin)
            line = (f"[kernel] {str(dtype)[6:]:8s} Cin={cin:3d} {h}x{w} E={e:3d} "
                    f"tile={th}x{tw} EC={ec} threads={threads} smem={smem} B "
                    f"max_abs_err={max_err:.3g} kernel {ms:.4f} ms | twin {plain_ms:.4f} ms")
            if dtype == torch.bfloat16:
                seq_ms = cuda_median_ms(lambda: _mbconv_sequence(x, *args))
                sequence_ms += repeats * seq_ms
                line += f" | unfused sequence (information) {seq_ms:.4f} ms"
            torch.cuda.synchronize()
            log(line)
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
                report["products"] += repeats * 2 * pixels * e * 2 * cin
                report["taps"] += repeats * 2 * 9 * pixels * e
            del x, args, got, want
        torch.cuda.empty_cache()
    # the 1x1s are matrix products at the tensor cores' bf16 rate; the
    # depthwise taps run on the CUDA cores in f32
    products, taps = report.pop("products"), report.pop("taps")
    report["bound_ms"], report["bound_by"] = bound_ms(
        report.pop("bytes"), (products, PEAK_FLOPS[torch.bfloat16]),
        (taps, PEAK_FLOPS[torch.float32]))
    log(f"[kernel] bf16 one forward (ten launches): kernel {report['ms']:.4f} ms | twin "
        f"{report['plain_ms']:.4f} ms | unfused sequence of three cuDNN convs with bias, "
        f"ReLU6 and residual passes (information) {sequence_ms:.4f} ms | bound "
        f"{report['bound_ms']:.4f} ms ({report['bound_by']}; {products / 1e9:.2f} GFLOP of "
        f"1x1s, {taps / 1e9:.2f} GFLOP of taps)")
    report["library_ms"] = None
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


def phase_scan_kernel_vs_plain():
    """Phase 3b.  Returns the scan kernel's report at (16, 4, 256)."""
    from ssdseglib_torch.ops.nms import _pairwise_iou_yx, _top_candidates
    from ssdseglib_torch.ops.nms_scan import greedy_select, greedy_select_reference

    builder, model, nms = _builder()
    infer = builder.get_model_for_inference(
        model_trained=model, compute_dtype="bfloat16", fused_backbone=True, device="cuda",
        **nms)
    _, labels, boxes_yx = infer.raw_outputs(_uint8_images(3, BATCH))
    # the top-K prefilter of combined_nms(method="topk"), as it feeds the scan
    scores, boxes = _top_candidates(boxes_yx, labels.transpose(1, 2), 256)
    flagship = (_pairwise_iou_yx(boxes), scores > SCORE_THRESHOLD, IOU_THRESHOLD, 4)
    cases = [("flagship (16, 4, 256)", *flagship)]
    gen = torch.Generator().manual_seed(2)
    for shape, iou_thr, max_keep in (((2, 2, 100), 0.4, 4), ((1, 1, 1), 0.5, 4),
                                     ((3, 4, 1024), 0.1, 1100)):
        def draw(low, high):
            return (torch.rand(*shape, generator=gen) * (high - low) + low).to("cuda")

        cy, cx, h, w = draw(0, 200), draw(0, 200), draw(5, 60), draw(5, 60)
        boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], dim=-1)
        cases.append((f"synthetic {shape}", _pairwise_iou_yx(boxes), draw(0, 1) > 0.3,
                      iou_thr, max_keep))
    mismatches = 0
    for name, iou, valid, iou_thr, max_keep in cases:
        want = greedy_select_reference(iou, valid, iou_thr, max_keep)
        for threshold in (iou_thr, torch.tensor(iou_thr, device="cuda")):
            got = greedy_select(iou, valid, threshold, max_keep)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            mismatches += bad
            kind = "0-d tensor" if isinstance(threshold, torch.Tensor) else "float"
            log(f"[scan] {name} iou > {iou_thr} ({kind}) max_keep {max_keep}: "
                f"{int(valid.sum())} valid, {int(want.sum())} kept, {bad} mismatches")
            if bad:
                raise AssertionError(f"scan kernel disagrees with its plain version: {name}")
    iou, valid, iou_thr, max_keep = flagship
    ms = cuda_median_ms(lambda: greedy_select(iou, valid, iou_thr, max_keep))
    device_thr = torch.tensor(iou_thr, device="cuda")  # as the serving path holds it
    tensor_ms = cuda_median_ms(lambda: greedy_select(iou, valid, device_thr, max_keep))
    plain_ms = cuda_median_ms(lambda: greedy_select_reference(iou, valid, iou_thr, max_keep))
    # every IoU read once and compared once; the walk's dependent steps are
    # latency the bound ignores
    least, by = bound_ms(iou.numel() * 4 + 2 * valid.numel(),
                         (iou.numel(), PEAK_FLOPS[torch.float32]))
    log(f"[scan] (16, 4, 256): kernel {ms:.4f} ms with a float threshold (one fill launch "
        f"more), {tensor_ms:.4f} ms with a 0-d tensor | plain {plain_ms:.4f} ms | bound "
        f"{least:.4f} ms ({by})")
    return dict(max_abs_err=float(mismatches), ms=ms, plain_ms=plain_ms, bound_ms=least,
                bound_by=by, library_ms=None)


# OIHW shapes of the six folded convs of the stem and block 1
STEM_CONVS = (("backbone-block0-expand", (32, 3, 3, 3)),
              ("backbone-block0-depthwise", (32, 1, 3, 3)),
              ("backbone-block0-project", (16, 32, 1, 1)),
              ("backbone-block1-expand", (96, 16, 1, 1)),
              ("backbone-block1-depthwise", (96, 1, 3, 3)),
              ("backbone-block1-project", (24, 96, 1, 1)))


# The previous design's figures at the serving shape (PERF.md §6: the
# CUDA-core stem kernel), printed beside this run's for reference
STEM_PARENT = ("wrapper 0.990-1.023 ms, kernel alone 0.916 ms, NVIDIA H100 80GB HBM3, "
               "700 W")


def _stem_weights(gen, dtype):
    """Random folded convs of the stem and block 1, and the kernel's twelve
    arguments made from them (`stem_block1_args`)."""
    from ssdseglib_torch.ops.s2d_stem import stem_block1_args

    folded = {}
    for name, shape in STEM_CONVS:
        fan_in = shape[1] * shape[2] * shape[3]
        kernel = (torch.randn(*shape, generator=gen) * 2.0 * fan_in ** -0.5).to("cuda", dtype)
        folded[name] = (kernel.contiguous(memory_format=torch.channels_last),
                        (torch.randn(shape[0], generator=gen) * 0.1).to("cuda", dtype))
    return folded, stem_block1_args(folded)


def _ulp_histogram(got, want) -> str:
    """How many bf16 ulps apart got and want are, element by element: counts
    at 0, 1, 2, 3, 4 and more."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7fff), bits)

    ulps = (ordered(got) - ordered(want)).abs()
    counts = [int((ulps == i).sum()) for i in range(5)] + [int((ulps > 4).sum())]
    return " ".join(f"{label}:{n}" for label, n in zip(("0", "1", "2", "3", "4", ">4"), counts))


def _events_ms(fn, launches: int = 20, warmup: int = 3) -> float:
    """``fn`` called ``launches`` times between two CUDA events, per call:
    the device time of back-to-back launches, the host's gaps hidden."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def phase_stem_kernel_vs_plain():
    """Phase 3c.  Returns the stem kernel's report at (16, 480, 640, 3) bf16.
    bf16 is held to the plain version that sums in the kernel's tensor-core
    order (``k_groups=True``; its largest difference is the reported error)
    and compared with the JAX-order plain version for information; f32 (the
    CUDA-core kernel) to the plain version."""
    from ssdseglib_torch.models.fused_inference import _block_convs, _conv
    from ssdseglib_torch.ops import s2d_stem

    def six_convs(folded, x):
        """Stem and block 1 as the default path runs them: six cuDNN convs
        with their bias and clamp passes, on a channels-last NCHW view."""
        (we, be), (wd, bd), (wp, bp) = _block_convs(folded, 0)
        x = _conv(x.permute(0, 3, 1, 2), we, be, stride=2, relu6=True)
        x = _conv(_conv(x, wd, bd, depthwise=True, relu6=True), wp, bp)
        (we, be), (wd, bd), (wp, bp) = _block_convs(folded, 1)
        d = _conv(_conv(x, we, be, relu6=True), wd, bd, stride=2, depthwise=True, relu6=True)
        return _conv(d, wp, bp).permute(0, 2, 3, 1)

    gen = torch.Generator().manual_seed(3)
    report = {"max_abs_err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        folded, args = _stem_weights(gen, dtype)
        for shape in ((BATCH, 480, 640, 3), (3, 36, 52, 3)):
            x = (torch.rand(*shape, generator=gen) * 2.0 - 1.0).to("cuda", dtype)
            got = s2d_stem.fused_stem_block1(x, args)
            torch.cuda.synchronize()
            tag = f"{str(dtype)[6:]:8s} {shape}"
            plain = s2d_stem.fused_stem_block1_reference(x, args)
            if dtype == torch.bfloat16:
                twin = s2d_stem.fused_stem_block1_reference(x, args, k_groups=True)
                err = _check_close(f"stem + block 1 {tag} against the k-group twin", got, twin,
                                   TOLERANCE[dtype])
                jax_order = float(((got.float() - plain.float()).abs()
                                   / (1.0 + plain.float().abs())).max())
                log(f"[stem] {tag} bf16 ulps from the k-group twin {_ulp_histogram(got, twin)} "
                    f"| from the JAX-order twin {_ulp_histogram(got, plain)}, largest "
                    f"|diff| / (1 + |twin|) {jax_order:.3g} (information: the two twins differ "
                    f"by {_ulp_histogram(twin, plain)})")
            else:
                err = _check_close(f"stem + block 1 {tag}", got, plain, TOLERANCE[dtype])
            report["max_abs_err"] = max(report["max_abs_err"], err)
            convs = six_convs(folded, x)
            log(f"[stem] {tag} -> {tuple(got.shape)} max_abs_err {err:.3g} (max |output| "
                f"{float(plain.float().abs().max()):.3g}, limit {TOLERANCE[dtype]} of 1 + |twin|); "
                f"six-conv route differs by at most "
                f"{float((convs.float() - plain.float()).abs().max()):.3g}")
            del plain, convs
            if dtype != torch.bfloat16 or shape[0] != BATCH:
                continue
            to, tw, ec, warps, smem = s2d_stem.kernel_config(480, 640)
            ms = cuda_median_ms(lambda: s2d_stem.fused_stem_block1(x, args))
            alone_ms = _events_ms(lambda: s2d_stem._launch(x, args))
            plain_ms = cuda_median_ms(lambda: s2d_stem.fused_stem_block1_reference(x, args))
            convs_ms = cuda_median_ms(lambda: six_convs(folded, x))
            b, h, w, _ = shape
            half, quarter = b * (h // 2) * (w // 2), b * (h // 4) * (w // 4)
            products = 2 * (half * (27 * 32 + 32 * 16 + 16 * 96) + quarter * 96 * 24)
            stencils = 2 * 9 * (half * 32 + quarter * 96)
            nbytes = 2 * (x.numel() + got.numel() + sum(a.numel() for a in args))
            least, by = bound_ms(nbytes, (products, PEAK_FLOPS[torch.bfloat16]),
                                 (stencils, PEAK_FLOPS[torch.float32]))
            log(f"[stem] {tag}: tile {to}x{tw} at H/4, chunk {ec} of 96, {warps * 32} threads, "
                f"{smem} B shared | wrapper {ms:.4f} ms | kernel alone {alone_ms:.4f} ms (20 "
                f"launches between CUDA events) | plain {plain_ms:.4f} ms | six cuDNN convs with "
                f"bias and clamp passes (information) {convs_ms:.4f} ms | bound {least:.4f} ms "
                f"({by}; {(products + stencils) / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) | "
                f"previous design: {STEM_PARENT}")
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=least, bound_by=by,
                          library_ms=None)
        torch.cuda.empty_cache()
    return report


def phase_backward_kernels_vs_plain(card: str):
    """Phase 4.  Returns {"depthwise_backward": report, "chain_backward":
    report} with the timings of the path's shape in bf16."""
    import torch.nn.functional as F

    from ssdseglib_torch.ops import depthwise_backward as dwb
    from ssdseglib_torch.ops import fused_chain_backward as fcb

    gen = torch.Generator().manual_seed(1)
    chain_gen = torch.Generator().manual_seed(6)  # the chain-only shape's own stream
    reports = {name: {"max_abs_err": 0.0} for name in ("depthwise_backward",
                                                       "chain_backward")}
    for dtype in (torch.bfloat16, torch.float32):
        elem = 2 if dtype == torch.bfloat16 else 4
        for shape in CHAIN_SHAPES:
            b, h, w, c = shape
            n = b * h * w * c
            source = gen if shape in BACKWARD_SHAPES else chain_gen

            def draw(*dims, scale=1.0, shift=0.0):
                return (torch.randn(*dims, generator=source) * scale + shift).to("cuda")

            x = draw(*shape, scale=2.0).to(dtype)
            dy = draw(*shape).to(dtype)
            kernel = draw(3, 3, 1, c, scale=0.5).to(dtype)
            gamma, beta = draw(c, scale=0.1, shift=1.0), draw(c, scale=0.1)
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last views, as in the model
            dy_nchw = dy.permute(0, 3, 1, 2)
            weight = kernel.permute(3, 2, 0, 1).contiguous()
            tag = f"{str(dtype)[6:]:8s} {shape}"

            # -- depthwise 3x3 backward
            if shape in BACKWARD_SHAPES:
                dx, dk = dwb.depthwise3x3_backward(x, dy, kernel)
                torch.cuda.synchronize()
                dx_ref, dk_ref = dwb.depthwise3x3_backward_reference(x, dy, kernel)
                errs = [_check_close(f"depthwise backward dx {tag}", dx, dx_ref,
                                     TOLERANCE[dtype]),
                        _check_close(f"depthwise backward dk {tag}", dk, dk_ref, SUM_TOLERANCE,
                                     scale_by_max=True)]
                ms = cuda_median_ms(lambda: dwb.depthwise3x3_backward(x, dy, kernel))
                plain_ms = cuda_median_ms(
                    lambda: dwb.depthwise3x3_backward_reference(x, dy, kernel))
                library_ms = cuda_median_ms(lambda: torch.ops.aten.convolution_backward(
                    dy_nchw, x_nchw, weight, None, [1, 1], [1, 1], [1, 1], False, [0, 0], c,
                    [True, True, False]))
                least, by = bound_ms(3 * n * elem + 2 * 9 * c * 4,
                                     (36 * n, PEAK_FLOPS[torch.float32]))
                log(f"[dw-bwd] {tag} max_abs_err dx {errs[0]:.3g} dk {errs[1]:.3g} | kernel "
                    f"{ms:.4f} ms | plain {plain_ms:.4f} ms | aten.convolution_backward "
                    f"{library_ms:.4f} ms | bound {least:.4f} ms ({by})")
                rep = reports["depthwise_backward"]
                rep["max_abs_err"] = max(rep["max_abs_err"], *errs)
                if dtype == torch.bfloat16 and shape == BACKWARD_SHAPES[0]:
                    rep.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                               bound_ms=least, bound_by=by)

            # -- dw + BN + ReLU6 chain backward, called as the autograd unit
            #    calls it: the forward's coefficients, the weight's HWIO view
            y, u_nchw, mean, var, coefficients = fcb._forward_math(x_nchw, weight, gamma, beta)
            u = u_nchw.permute(0, 2, 3, 1)
            taps = weight.permute(2, 3, 1, 0)
            args = (x, u, dy, taps, gamma, beta, mean, var, coefficients)
            got = fcb.dw_bn_relu6_backward(*args)
            torch.cuda.synchronize()
            again = fcb.dw_bn_relu6_backward(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"chain backward {tag}: two calls give other bits")
            want = fcb.dw_bn_relu6_backward_reference(x, u, dy, kernel, gamma, beta, mean, var)
            errs = [_check_close(f"chain backward dx {tag}", got[0], want[0], TOLERANCE[dtype])]
            errs += [_check_close(f"chain backward {name} {tag}", g, r, SUM_TOLERANCE,
                                  scale_by_max=True)
                     for name, g, r in zip(("dk", "dgamma", "dbeta"), got[1:], want[1:])]
            ms = cuda_median_ms(lambda: fcb.dw_bn_relu6_backward(*args))
            outs = (torch.empty_like(x), torch.empty((9, c), dtype=torch.float32, device="cuda"),
                    torch.empty((2, c), dtype=torch.float32, device="cuda"))
            alone_ms = _events_ms(lambda: fcb._launch(x, u, dy, taps, coefficients, out=outs))
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
            # bytes: pass 1 reads u and dy, pass 2 reads x, u, dy and writes dx
            # (dbeta and dgamma must be known before any du, and u and dy do
            # not stay in L2 between the passes)
            least, by = bound_ms(6 * n * elem + 2 * 9 * c * 4,
                                 (56 * n, PEAK_FLOPS[torch.float32]))
            log(f"[chain-bwd] {tag} max_abs_err dx {errs[0]:.3g} dk {errs[1]:.3g} dgamma "
                f"{errs[2]:.3g} dbeta {errs[3]:.3g}, same bits on two calls | wrapper {ms:.4f} ms "
                f"| kernels alone {alone_ms:.4f} ms (20 calls of the two launches between CUDA "
                f"events) | plain {plain_ms:.4f} ms | ATen autograd route {aten_ms:.4f} ms | "
                f"bound {least:.4f} ms ({by}) | forward vs ATen route max diff {fwd_diff:.3g}"
                f"{' (bit for bit)' if fwd_diff == 0.0 else ''}")
            rep = reports["chain_backward"]
            rep["max_abs_err"] = max(rep["max_abs_err"], *errs)
            if dtype == torch.bfloat16 and shape == BACKWARD_SHAPES[0]:
                rep.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=least,
                           bound_by=by)
                # counted in phase 4b, in the process's one profiling session
                rep["call"] = lambda call_args=args: fcb.dw_bn_relu6_backward(*call_args)
            del leaves, y_aten, y, u_nchw, u, args, got, again, want, outs
            torch.cuda.empty_cache()
    return reports


def _kernel_name(key: str) -> str:
    """A profiler kernel key without its namespace, template and signature."""
    return key.replace("(anonymous namespace)::", "").replace("void ", "").split("<")[0] \
        .split("(")[0]


def _device_kernels(fns, calls: int = 10):
    """[(kernel name, launches, device ms)] of ``calls`` calls of each of
    ``fns``, in turns, from torch.profiler, after a first call of each that
    may allocate cached scratch.  The profiler records a warm-up step of the
    same calls and drops it, then counts the next step.  A process runs one
    profiling session: a second one has been seen to miss some or all of the
    kernels it should count."""
    from torch.profiler import ProfilerActivity, profile, schedule

    counted = []

    def count(prof) -> None:
        counted.append([(e.key, e.count, e.self_device_time_total / 1e3)
                        for e in prof.key_averages() if e.device_type.name == "CUDA"])

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], on_trace_ready=count,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
            prof.step()
    assert len(counted) == 1, counted
    return counted[0]


# (leading axes, Ci, Co): the two layers of the flagship model inside the
# weight-gradient kernels' envelope (backbone-block0-project, backbone-block1-
# expand) at batch 16 and at batch 2, then a ragged shape outside the model
WGRAD_SHAPES = [((16, 240, 320), 32, 16), ((16, 240, 320), 16, 96),
                ((2, 240, 320), 32, 16), ((2, 240, 320), 16, 96), ((3, 37, 53), 48, 32)]
# the shapes a kernel's main path gives it: (dtype, indices into WGRAD_SHAPES)
WGRAD_PATH = {"wgrad_mma": (torch.bfloat16, (0, 1)), "wgrad_fma": (torch.float32, (2, 3)),
              "wgrad_copy": (torch.bfloat16, (0,))}


def phase_wgrad_kernels_vs_plain(card: str, chain_call):
    """Phase 4b.  Returns {"wgrad_mma": report, "wgrad_fma": report,
    "wgrad_copy": report}: timings summed over the shapes of WGRAD_PATH, and
    the launches of `wgrad_copy` in the study (its main path)."""
    from ssdseglib_torch.ops import pointwise_wgrad as pw

    kernels = {"wgrad_mma": (pw.wgrad_mma, pw.wgrad_mma_reference),
               "wgrad_fma": (pw.wgrad_fma, pw.wgrad_fma_reference),
               "wgrad_copy": (pw.wgrad_copy, pw.wgrad_copy_reference)}
    reports = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0,
                          flops=0.0) for name in kernels}
    gen = torch.Generator().manual_seed(4)
    for dtype in (torch.bfloat16, torch.float32):
        elem = 2 if dtype == torch.bfloat16 else 4
        for index, (lead, ci, co) in enumerate(WGRAD_SHAPES):
            x = torch.randn(*lead, ci, generator=gen).to("cuda", dtype)
            dy = torch.randn(*lead, co, generator=gen).to("cuda", dtype)
            weight = torch.zeros((co, ci, 1, 1), dtype=dtype, device="cuda")
            k = x.numel() // ci

            def library():
                return torch.ops.aten.convolution_backward(
                    dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight, None, [1, 1],
                    [0, 0], [1, 1], False, [0, 0], 1, [False, True, False])

            library_first = cuda_median_ms(library)
            timed = {}
            for name, (kernel, plain) in kernels.items():
                if name == "wgrad_mma" and dtype != torch.bfloat16:
                    continue
                timed[name] = cuda_median_ms(lambda: kernel(x, dy))
            # the library before and after the kernels: the kernels are timed in turns with it
            library_ms = (library_first + cuda_median_ms(library)) / 2
            for name, (kernel, plain) in kernels.items():
                if name == "wgrad_mma" and dtype != torch.bfloat16:
                    continue
                got = kernel(x, dy)
                torch.cuda.synchronize()
                tag = f"{name} {str(dtype)[6:]:8s} {lead} {ci} -> {co}"
                err = _check_close(tag, got, plain(x, dy), SUM_TOLERANCE, scale_by_max=True)
                ms = timed[name]
                plain_ms = cuda_median_ms(lambda: plain(x, dy))
                # products on the tensor cores (mma) or the CUDA cores (fma);
                # the loads-alone kernel does one add per element
                flops, rate = {
                    "wgrad_mma": (2 * k * ci * co, PEAK_FLOPS[torch.bfloat16]),
                    "wgrad_fma": (2 * k * ci * co, PEAK_FLOPS[torch.float32]),
                    "wgrad_copy": (k * (ci + co), PEAK_FLOPS[torch.float32])}[name]
                nbytes = k * (ci + co) * elem + ci * co * 4
                least, by = bound_ms(nbytes, (flops, rate))
                log(f"[wgrad] {tag} max_abs_err {err:.3g} | kernel {ms:.4f} ms | plain "
                    f"{plain_ms:.4f} ms | aten.convolution_backward (weight only) "
                    f"{library_ms:.4f} ms (mean of {library_first:.4f} before and the reading "
                    f"after the kernels) | bound {least:.4f} ms ({by})")
                rep = reports[name]
                rep["max_abs_err"] = max(rep["max_abs_err"], err)
                path_dtype, path_shapes = WGRAD_PATH[name]
                if dtype == path_dtype and index in path_shapes:
                    rep["ms"] += ms
                    rep["plain_ms"] += plain_ms
                    rep["library_ms"] += library_ms
                    rep["bytes"] += nbytes
                    rep["flops"] += flops
                    rep["rate"] = rate
            del x, dy
            torch.cuda.empty_cache()
    for rep in reports.values():
        rep["bound_ms"], rep["bound_by"] = bound_ms(
            rep.pop("bytes"), (rep.pop("flops"), rep.pop("rate")))

    # the study that chooses the route: the loads-alone kernel's main path
    lead, ci, co = WGRAD_SHAPES[0]
    x = torch.randn(*lead, ci, generator=gen).to("cuda", torch.bfloat16)
    dy = torch.randn(*lead, co, generator=gen).to("cuda", torch.bfloat16)
    for kernel, _ in kernels.values():
        kernel.launches = 0
    study = pw.wgrad_study(x, dy)
    reports["wgrad_copy"]["launches"] = pw.wgrad_copy.launches
    log(f"[wgrad-study] {lead} {ci} -> {co} bf16: wgrad_mma off the f32 product by "
        f"{study['rel_err']:.3g} of the largest magnitude (limit 2e-2)")
    for arm in ("aten", "dot", "mma", "copy", "fma"):
        log(f"[wgrad-study] {arm:5s} {study[arm + '_ms']:.4f} ms (CUDA events, median of 20) "
            f"| {card}")
    _launches_and_allocations(gen, chain_call, card)
    for lead, ci, co in WGRAD_SHAPES[:2]:
        x = torch.randn(*lead, ci, generator=gen).to("cuda", torch.bfloat16)
        dy = torch.randn(*lead, co, generator=gen).to("cuda", torch.bfloat16)
        alone = {name: _wgrad_alone_ms(kernel, x, dy) for name, kernel in
                 (("mma", pw._MMA), ("fma", pw._FMA), ("copy", pw._COPY))}
        log(f"[wgrad] kernels alone (launchers called directly, 50 launches between two "
            f"CUDA events) bf16 {lead} {ci} -> {co}: "
            + " | ".join(f"{name} {ms:.4f} ms" for name, ms in alone.items()) + f" | {card}")
    return reports


def _launches_and_allocations(gen, chain_call, card: str, calls: int = 10) -> None:
    """Device kernels a call launches, from one torch.profiler session over
    both: `wgrad_mma` at the training path's first layer (one launch) and
    ``chain_call``, the chain backward at its path's shape (two launches,
    with each one's device time); no other kernel may run.  And the
    allocations a `wgrad_mma` call makes after the first (the caching
    allocator's count): one -- the gradient it returns -- with no scratch."""
    from ssdseglib_torch.ops import pointwise_wgrad as pw

    lead, ci, co = WGRAD_SHAPES[0]
    x = torch.randn(*lead, ci, generator=gen).to("cuda", torch.bfloat16)
    dy = torch.randn(*lead, co, generator=gen).to("cuda", torch.bfloat16)
    pw.wgrad_mma(x, dy, torch.bfloat16)  # the first call allocates the scratch
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    kept = [pw.wgrad_mma(x, dy, torch.bfloat16) for _ in range(calls)]
    allocations = (torch.cuda.memory_stats()["allocation.all.allocated"] - before) / calls
    rows = _device_kernels([lambda: pw.wgrad_mma(x, dy, torch.bfloat16), chain_call], calls)
    wgrad = sum(n for key, n, _ in rows if "wgrad_mma" in key)
    chain = [(_kernel_name(key), n, ms) for key, n, ms in rows if "chain_" in key]
    others = sum(n for _, n, _ in rows) - wgrad - sum(n for _, n, _ in chain)
    log(f"[wgrad] wgrad_mma {lead} {ci} -> {co} bf16 -> (Co, Ci) bf16: {wgrad / calls:g} "
        f"device kernel(s) and {allocations:g} allocation(s) per call after the first "
        f"(the returned gradient); scratch buffers cached: {len(pw._SCRATCH)}")
    log(f"[chain-bwd] bfloat16 {BACKWARD_SHAPES[0]}: "
        f"{sum(n for _, n, _ in chain) / calls:g} device kernel(s) per call, device time "
        + ", ".join(f"{name} {ms / calls:.4f} ms" for name, _, ms in chain)
        + f" (torch.profiler); other kernels in the window: {others} | previous design: "
        f"{CHAIN_PARENT} | {card}")
    assert wgrad == calls and allocations == 1, (wgrad, allocations)
    assert sum(n for _, n, _ in chain) == 2 * calls and others == 0, (chain, others)
    del kept


def _wgrad_alone_ms(kernel: int, x, dy, rows: int = 0, ctas: int = 0,
                    launches: int = 50, check: bool = False) -> float:
    """One weight-gradient kernel alone: its C launcher called ``launches``
    times between two CUDA events (the wrapper's host time out of the
    reading), with the (rows, CTAs) given, 0 for the built-in choice.  With
    ``check``, the result is held against the plain version first."""
    from ssdseglib_torch.ops import _cuda_build
    from ssdseglib_torch.ops import pointwise_wgrad as pw

    lib = _cuda_build.load_library()
    ci, co = x.shape[-1], dy.shape[-1]
    k = x.numel() // ci
    stream = torch.cuda.current_stream().cuda_stream
    partials, counters = pw._scratch(x.device, stream, ci, co,
                                     *pw._grid(lib, kernel, k, ci, co, ctas))
    out = torch.empty((co, ci), dtype=torch.float32, device="cuda")
    dtype = pw._DTYPE_CODES[x.dtype]

    def launch():
        err = lib.pointwise_wgrad_launch(kernel, dtype, x.data_ptr(), dy.data_ptr(),
                                         partials.data_ptr(), counters.data_ptr(),
                                         out.data_ptr(), 0, k, ci, co, rows, ctas, stream)
        assert err == 0, (kernel, rows, ctas, err)

    for _ in range(5):
        launch()
    if check:
        plain = (pw.wgrad_copy_reference if kernel == pw._COPY else pw.wgrad_mma_reference)
        _check_close(f"wgrad kernel {kernel} rows {rows} CTAs {ctas}", out, plain(x, dy),
                     SUM_TOLERANCE, scale_by_max=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(launches):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


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
    for m in (fused, plain):
        m.set_nms_operating_point(boxes_iou_threshold=IOU_THRESHOLD,
                                  labels_probability_threshold=SCORE_THRESHOLD)
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


SERVE_STEPS, SERVE_ROUNDS = 16, 3


def _images_per_second(serve, inputs):
    """bench.py's protocol: per round, SERVE_STEPS pipelined calls of
    ``serve`` (returning (mask, detections)) over the distinct batches in
    ``inputs``, fenced by fetching the last step's detections.  Returns the
    images/s of each round."""
    rates = []
    for _ in range(SERVE_ROUNDS):
        t0 = time.perf_counter()
        outs = [serve(inputs[i % len(inputs)]) for i in range(SERVE_STEPS)]
        outs[-1][1].cpu()  # the fence
        rates.append(SERVE_STEPS * BATCH / (time.perf_counter() - t0))
    return rates


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

    rates = _images_per_second(infer, inputs)
    calls += SERVE_ROUNDS * SERVE_STEPS
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
    _serving_kernel_vs_plain(infer)
    return launches, statistics.median(rates)


# Kernel path against the same path with the MBConv kernel's plain version,
# bf16 b16: both round to bf16 at every layer (about 60), so one or two ulps of
# difference in a block output (the kernel sums in another order) travel on
# through ten blocks and the heads; 2^-8 relative per rounding over ~60 of
# them adds up to about 2e-2, so 3e-2 of (1 + |plain|) is the limit.
SERVE_PLAIN_TOLERANCE = 3e-2


def _serving_kernel_vs_plain(infer) -> None:
    """Phase 6, last: the default path's raw outputs (mask, class
    probabilities, decoded boxes) with the kernel against the same path with
    `fused_mbconv_reference` in the kernel's place, on the card, bf16 b16."""
    from ssdseglib_torch.models import fused_inference
    from ssdseglib_torch.ops.fused_mbconv import fused_mbconv_reference

    images = _uint8_images(3, BATCH)
    got = [t.float() for t in infer.raw_outputs(images)]
    real = fused_inference.fused_mbconv
    fused_inference.fused_mbconv = lambda x, *args, residual=True: fused_mbconv_reference(
        x, *args, residual=residual)
    try:
        want = [t.float() for t in infer.raw_outputs(images)]
    finally:
        fused_inference.fused_mbconv = real
    for name, a, b in zip(("mask", "labels", "boxes"), got, want):
        # probabilities element by element; box corners (pixels, decoded
        # from bf16 offsets times the anchor's size) against the image's scale
        scale = 1.0 + (b.abs().max() if name == "boxes" else b.abs())
        err = (a - b).abs() / scale
        log(f"[serve] bf16 b16 {name} {tuple(a.shape)}: kernel path vs plain-version path, "
            f"max |diff| / (1 + |plain|{' max' if name == 'boxes' else ''}) = "
            f"{float(err.max()):.3g}, max |diff| {float((a - b).abs().max()):.3g} (limit "
            f"{SERVE_PLAIN_TOLERANCE})")
        assert bool(torch.isfinite(a).all()), name
        assert float(err.max()) <= SERVE_PLAIN_TOLERANCE, (name, float(err.max()))


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


ROUTES = {  # name -> (chain gate, depthwise gate, weight-gradient gate)
    "aten": ("aten", "aten", "aten"), "chain": ("cuda", "aten", "aten"),
    "depthwise": ("aten", "cuda", "aten"), "wgrad-dot": ("aten", "aten", "dot"),
    "wgrad-cuda": ("aten", "aten", "cuda")}
BACKWARD_ROUTES = ("aten", "chain", "depthwise")  # phase 7
WGRAD_ROUTES = ("aten", "wgrad-dot", "wgrad-cuda")  # phase 9


def _set_route(name: str) -> None:
    from ssdseglib_torch.models import blocks

    chain_gate, depthwise_gate, wgrad_gate = ROUTES[name]
    blocks.set_chain_bwd_impl(chain_gate)
    blocks.set_depthwise_bwd_impl(depthwise_gate)
    blocks.set_wgrad_impl(wgrad_gate)


def _routes_agree_f32(tag: str, trainer, batch, routes) -> None:
    """The loss (1e-5) and every gradient of one f32 step under ``routes``
    against the first of them: per tensor, the norm of the difference over
    the tensor's norm (floored at 1e-4 of the largest) within
    GRADIENT_TOLERANCE."""
    results = {}
    for route in routes:
        _set_route(route)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        metrics, grads, _ = trainer.loss_and_grads(state, *batch)
        results[route] = float(metrics["loss"]), grads
    loss_ref, grads_ref = results[routes[0]]
    floor = 1e-4 * max(float(torch.linalg.vector_norm(g)) for g in grads_ref.values())
    for route in routes[1:]:
        loss, grads = results[route]
        worst = max(
            float(torch.linalg.vector_norm(grads[k] - grads_ref[k])
                  / torch.linalg.vector_norm(grads_ref[k]).clamp_min(floor))
            for k in grads_ref)
        log(f"[{tag}] f32 b2 route {route}: loss {loss:.6f} vs {routes[0]} {loss_ref:.6f}; "
            f"largest relative gradient difference of a tensor {worst:.3g} "
            f"({len(grads_ref)} tensors)")
        assert abs(loss - loss_ref) <= 1e-5 * abs(loss_ref), (route, loss, loss_ref)
        assert worst <= GRADIENT_TOLERANCE, (route, worst)


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
        _routes_agree_f32("train", trainer, small, BACKWARD_ROUTES)
        del trainer

        # (b), (c) bf16, batch 16: steps on one batch under each route
        trainer = Trainer(model=model, anchors=anchors,
                          config=TrainConfig(batch_size=BATCH, compute_dtype="bfloat16"))
        launches, report = {}, {}
        for route in BACKWARD_ROUTES:
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


def _option_path_parts():
    """The pieces of the option path as a caller writes it, on the flagship
    configuration: (make_forward(dtype, s2d_stem), gate_and_decode(out),
    postprocess(out, method), the score threshold as a 0-d device tensor,
    K = max_candidates_per_class)."""
    from ssdseglib_torch.boxes import Anchors
    from ssdseglib_torch.config import reference_warehouse_config
    from ssdseglib_torch.layers import SegmentationSuppression
    from ssdseglib_torch.models.fused_inference import make_fused_forward
    from ssdseglib_torch.ops.encoding import decode_predictions_to_corners_yx
    from ssdseglib_torch.ops.nms import combined_nms

    anchors_cfg, enc_cfg, model_cfg, nms_cfg, _ = reference_warehouse_config()
    anchors = torch.from_numpy(
        Anchors.from_config(anchors_cfg, enc_cfg.image_shape).centroids).to("cuda")
    state = _builder()[1].state_dict()
    suppression = SegmentationSuppression(4)
    thr_iou = torch.tensor(IOU_THRESHOLD, device="cuda")
    thr_score = torch.tensor(SCORE_THRESHOLD, device="cuda")

    def make_forward(dtype, s2d_stem):
        return make_fused_forward(model_cfg, state, compute_dtype=dtype, device="cuda",
                                  s2d_stem=s2d_stem)

    @torch.inference_mode()
    def gate_and_decode(out):
        labels = suppression(out["output-mask"], out["output-labels"].float())
        boxes = decode_predictions_to_corners_yx(
            out["output-boxes"].float(), anchors, enc_cfg.standard_deviations)
        return boxes, labels

    @torch.inference_mode()
    def postprocess(out, method):
        """(B, T, 6) rows [label, probability, ymin, xmin, ymax, xmax]."""
        det = combined_nms(*gate_and_decode(out), nms_cfg, method=method,
                           iou_threshold=thr_iou, score_threshold=thr_score)
        return torch.cat([det["classes"][..., None], det["scores"][..., None], det["boxes"]],
                         dim=-1)

    return make_forward, gate_and_decode, postprocess, thr_score, nms_cfg.max_candidates_per_class


def _serving_inputs():
    """Eight distinct uint8 batches of 16 and one single image, on the card."""
    base = np.random.default_rng(0).uniform(0, 255, (BATCH, 480, 640, 3))
    inputs = [torch.from_numpy(((base + float(i)) % 256.0).astype(np.uint8)).to("cuda")
              for i in range(8)]
    return inputs, torch.from_numpy(_uint8_images(2, 1)).to("cuda")


def phase_option_path(card: str, default_rate: float):
    """Phase 8.  Returns {"stem": launches, "scan": launches} counted over
    the bf16 b16 calls of the option path."""
    from ssdseglib_torch.models import fused_inference
    from ssdseglib_torch.ops.fused_mbconv import fused_mbconv
    from ssdseglib_torch.ops.nms_scan import greedy_select
    from ssdseglib_torch.ops.s2d_stem import fused_stem_block1

    make_forward, gate_and_decode, postprocess, thr_score, k = _option_path_parts()

    # (a) f32, batch 2: the option path against the default path
    option, default = (make_forward(torch.float32, s2d) for s2d in ("cuda", False))
    x = torch.from_numpy(_uint8_images(1, 2)).to("cuda")
    out, out_default = option(x), default(x)
    for name in ("output-mask", "output-labels", "output-boxes"):
        a, b = out[name].cpu().numpy(), out_default[name].cpu().numpy()
        log(f"[option] f32 b2 {name} {a.shape}: max |s2d_stem='cuda' - default| / "
            f"(1 + |default|) = {float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))):.3g}")
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3, err_msg=name)
    # top-K equals exact only while at most K candidates of a class clear the
    # score threshold: raise the threshold to the (K + 1)-th score if need be
    labels = gate_and_decode(out)[1]
    kth = labels.sort(dim=1, descending=True).values[:, k].max()
    thr_score.copy_(torch.maximum(thr_score, kth))
    most = int((labels > thr_score).sum(dim=1).max())
    assert most <= k, (most, k)
    det_topk, det_exact = postprocess(out, "topk").cpu(), postprocess(out, "exact").cpu()
    n_valid = int((det_exact[..., 1] > 0).sum())
    log(f"[option] f32 b2 topk vs exact at iou > {IOU_THRESHOLD}, score > "
        f"{float(thr_score):.4f}: at most {most} candidates per class (K = {k}), "
        f"{n_valid} valid rows")
    assert n_valid > 0, "no valid detection rows to compare"
    np.testing.assert_array_equal(det_topk[..., 0].numpy(), det_exact[..., 0].numpy())
    np.testing.assert_allclose(det_topk[..., 1:].numpy(), det_exact[..., 1:].numpy(),
                               rtol=2e-3, atol=2e-3)
    del option, default, out, out_default
    thr_score.fill_(SCORE_THRESHOLD)

    # (b) bf16, batch 16: one call through the three kernels
    option = make_forward(torch.bfloat16, "cuda")

    def serve(images):
        out = option(images)
        return out["output-mask"], postprocess(out, "topk")

    inputs, single = _serving_inputs()
    serve(inputs[0])  # warm-up
    serve(single)
    torch.cuda.synchronize()
    counters = {"stem": fused_stem_block1, "scan": greedy_select, "mbconv": fused_mbconv}
    for counter in counters.values():
        counter.launches = 0  # the option path starts here
    fused_inference.mobilenetv2_features_fused.copies = 0
    mask, det = serve(inputs[0])
    det_host = det.cpu()
    counts = {name: counter.launches for name, counter in counters.items()}
    assert counts == {"stem": 1, "scan": 1, "mbconv": 10}, counts
    assert tuple(mask.shape) == (BATCH, 480, 640, 4) and mask.dtype == torch.bfloat16
    assert tuple(det_host.shape) == (BATCH, 10, 6) and det_host.dtype == torch.float32
    assert bool(torch.isfinite(mask).all()) and bool(torch.isfinite(det_host).all())
    log(f"[option] bf16 b16 one call: kernel launches {counts}, mask {tuple(mask.shape)}, "
        f"detections {tuple(det_host.shape)}, {int((det_host[..., 1] > 0).sum())} valid rows")

    # (c) images/s under the serving phase's protocol
    rates = _images_per_second(serve, inputs)
    calls = 1 + SERVE_ROUNDS * SERVE_STEPS
    launches = {name: counter.launches for name, counter in counters.items()}
    assert launches == {"stem": calls, "scan": calls, "mbconv": 10 * calls}, (launches, calls)
    copies = fused_inference.mobilenetv2_features_fused.copies
    assert copies == 0, f"{copies} layout copies around the stem kernel"
    log(f"[option] b16 images/s, rounds: {[round(r, 2) for r in rates]}")
    log(f"[option] s2d_stem='cuda' + method='topk' at b16 480x640: "
        f"{statistics.median(rates):.2f} images/s | default path (phase 6, "
        f"get_model_for_inference, exact NMS): {default_rate:.2f} images/s | {card}")
    # the post-processing alone, on one forward's outputs
    for images in (inputs[0], single):
        out = option(images)
        times = {method: cuda_median_ms(lambda: postprocess(out, method))
                 for method in ("exact", "topk")}
        log(f"[option] post-processing alone (suppression + decode + NMS) at b"
            f"{images.shape[0]}: exact {times['exact']:.4f} ms | topk {times['topk']:.4f} ms "
            f"(CUDA events, median of 20) | {card}")
    return launches


def _wgrad_layers(model, dtype):
    """Names of the model's convs whose weight gradient ``set_wgrad_impl(
    'cuda')`` routes through the kernels: dense 1x1 stride-1 convs inside
    the envelope."""
    from ssdseglib_torch.models.blocks import SameConv2d
    from ssdseglib_torch.ops.conv_backward import reformulated
    from ssdseglib_torch.ops.pointwise_wgrad import wgrad_applicable

    return [name for name, m in model.named_modules()
            if isinstance(m, SameConv2d) and reformulated(m.weight, m.stride[0], m.groups)
            and wgrad_applicable(m.in_channels, m.out_channels, dtype)]


FIT_SAMPLES, FIT_EPOCHS = 32, 2


def phase_fit(card: str):
    """Phase 9.  Returns {"wgrad_mma": launches over the two epochs of `fit`,
    "wgrad_fma": launches over the f32 step of (a)}."""
    import shutil
    import tempfile

    from ssdseglib_torch import evaluators
    from ssdseglib_torch.boxes import Anchors
    from ssdseglib_torch.checkpoint import Checkpointer
    from ssdseglib_torch.config import TrainConfig, reference_warehouse_config
    from ssdseglib_torch.data.pipeline import TrainDataLoader
    from ssdseglib_torch.data.synthetic import generate_dataset
    from ssdseglib_torch.models.builder import SsdSegModel
    from ssdseglib_torch.ops import conv_backward
    from ssdseglib_torch.ops import pointwise_wgrad as pw
    from ssdseglib_torch.train import Trainer

    anchors_cfg, enc_cfg, model_cfg, _, _ = reference_warehouse_config()
    anchors = Anchors.from_config(anchors_cfg, enc_cfg.image_shape)
    samples = generate_dataset(FIT_SAMPLES, image_shape=enc_cfg.image_shape,
                               num_classes=enc_cfg.num_classes, seed=0)
    model = SsdSegModel(model_cfg, torch.Generator().manual_seed(0))
    layers = _wgrad_layers(model, torch.bfloat16)
    log(f"[fit] layers inside the weight-gradient kernels' envelope: {layers}")
    assert layers == _wgrad_layers(model, torch.float32) and len(layers) >= 2, layers
    config = TrainConfig(batch_size=BATCH, compute_dtype="bfloat16")
    steps_per_epoch = FIT_SAMPLES // BATCH
    directory = tempfile.mkdtemp(prefix="ssdseg_smoke_ckpt_")
    try:
        def loader():
            return TrainDataLoader(samples, anchors, enc_cfg, batch_size=BATCH,
                                   augmentation_horizontal_flip=True, augmentation_rgb=True,
                                   seed=0)

        # the run: loader -> fit (transform on the card) -> checkpoints
        _set_route("wgrad-cuda")
        trainer = Trainer(model=model, anchors=anchors, config=config)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        checkpointer = Checkpointer(directory)
        logs = []
        for counter in (pw.wgrad_mma, pw.wgrad_fma, pw.wgrad_copy):
            counter.launches = 0  # the main path starts here
        conv_backward.conv2d_fast_wgrad.copies = 0
        state, history = trainer.fit(state, loader(), epochs=FIT_EPOCHS,
                                     checkpointer=checkpointer, log_fn=logs.append)
        mma_launches = pw.wgrad_mma.launches
        for line in logs:
            log(f"[fit] {line}")
        steps = FIT_EPOCHS * steps_per_epoch
        assert state.step == steps, state.step
        assert mma_launches == len(layers) * steps, (mma_launches, layers, steps)
        assert pw.wgrad_fma.launches == 0 and pw.wgrad_copy.launches == 0
        assert conv_backward.conv2d_fast_wgrad.copies == 0, "hidden layout copies"
        losses = history["loss"]
        assert len(losses) == FIT_EPOCHS and all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses
        assert checkpointer.all_steps() == [steps_per_epoch * (e + 1) for e in range(FIT_EPOCHS)]
        log(f"[fit] {FIT_EPOCHS} epochs of {steps_per_epoch} steps under set_wgrad_impl('cuda'): "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, wgrad_mma launches {mma_launches} = "
            f"{len(layers)} layers x {steps} steps, checkpoints at steps "
            f"{checkpointer.all_steps()}")

        # resume: another trainer, other weights, restored to the saved state
        resumed = Trainer(model=model, anchors=anchors, config=config)
        other = resumed.init_state(torch.Generator().manual_seed(1))
        restored = Checkpointer(directory).restore(other)
        assert restored.step == steps
        for name, saved, back in (
                ("params", state.params, restored.params),
                ("batch_stats", state.batch_stats, restored.batch_stats),
                ("mu", state.opt_state.mu, restored.opt_state.mu),
                ("nu", state.opt_state.nu, restored.opt_state.nu)):
            for k, v in saved.items():
                assert back[k].dtype == v.dtype and torch.equal(back[k], v), (name, k)
        logs = []
        other, more = resumed.fit(other, loader(), epochs=1, resume=True,
                                  checkpointer=Checkpointer(directory), log_fn=logs.append)
        assert logs[0] == f"resumed from checkpoint step {steps}", logs
        assert other.step == steps + steps_per_epoch and np.isfinite(more["loss"][0])
        log(f"[fit] resume: state of step {steps} restored bit for bit into a second Trainer, "
            f"one more epoch to step {other.step}, loss {more['loss'][0]:.4f}")
        del resumed, restored

        # the evaluators on the trained model's predictions
        builder, _, nms = _builder()
        trained = SsdSegModel(model_cfg, torch.Generator().manual_seed(0))
        trained.load_state_dict({k: v.cpu() for k, v in other.variables().items()},
                                strict=False)
        infer = builder.get_model_for_inference(
            model_trained=trained.to("cuda"), compute_dtype="float32", device="cuda", **nms)
        held = samples[:BATCH]
        masks, detections = infer.predict(np.stack([s.image for s in held]))
        masks, detections = np.asarray(masks, np.float32), np.asarray(detections, np.float32)
        codes = list(range(enc_cfg.num_classes))
        ap = evaluators.average_precision_object_detection(
            detections[..., 0].astype(np.int32), detections[..., 1], detections[..., 2:6], 0.5,
            [(s.labels, s.boxes) for s in held], codes, 0)
        iou = evaluators.jaccard_iou_semantic_segmentation(
            masks, [s.mask for s in held], codes, 0)
        assert all(np.isfinite(v) for v in (*ap.values(), *iou.values())), (ap, iou)
        log(f"[fit] evaluators on {len(held)} samples after {other.step} steps: AP@0.5 {ap}, "
            f"soft IoU {iou}")
        del infer, trained

        # (a) f32, batch 2: one step under the three gates
        _, _, images, targets, _ = _train_batch(BATCH)
        small = images[:2], {k: v[:2] for k, v in targets.items()}
        trainer32 = Trainer(model=model, anchors=anchors,
                            config=TrainConfig(batch_size=2, compute_dtype="float32"))
        pw.wgrad_fma.launches = 0  # the CUDA-core kernel's main path starts here
        _routes_agree_f32("fit", trainer32, small, WGRAD_ROUTES)
        fma_launches = pw.wgrad_fma.launches
        assert fma_launches == len(layers), (fma_launches, layers)
        del trainer32

        # (b) bf16, batch 16: the step under the three gates, in turns (the
        # gates, then the gates in reverse), then a fit epoch
        report = {route: [] for route in WGRAD_ROUTES}
        for route in WGRAD_ROUTES + WGRAD_ROUTES[::-1]:
            _set_route(route)
            state = trainer.init_state(torch.Generator().manual_seed(0))
            trainer.train_step(state, images, targets)[1]["loss"].item()  # warm-up
            times = []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                trainer.train_step(state, images, targets)[1]["loss"].item()  # the fence
                times.append((time.perf_counter() - t0) * 1e3)
            report[route].append(statistics.median(times))
        for route, medians in report.items():
            log(f"[fit] bf16 b16 gate {ROUTES[route][2]}: step {medians[0]:.3f} / "
                f"{medians[1]:.3f} ms (median of {TRAIN_STEPS}, fetch-fenced, in turns "
                f"aten-dot-cuda-cuda-dot-aten), {BATCH / min(medians) * 1e3:.2f} images/s "
                f"at the faster | {card}")
        report = {route: min(medians) for route, medians in report.items()}
        # the run's own epoch (2 steps), and a longer one over the same samples
        # four times (8 steps, one staged chunk), where start-up weighs less
        _set_route("wgrad-cuda")
        for repeat in (1, 4):
            data = TrainDataLoader(samples * repeat, anchors, enc_cfg, batch_size=BATCH,
                                   augmentation_horizontal_flip=True, augmentation_rgb=True,
                                   seed=0)
            rates = []
            for _ in range(3):
                t0 = time.perf_counter()
                trainer.fit(state, data, epochs=1, log_fn=lambda line: None)
                rates.append(len(data) * BATCH / (time.perf_counter() - t0))
            log(f"[fit] fit epoch of {len(data)} steps over TrainDataLoader (flip and rgb, "
                f"transform on the card, gate cuda), rounds: {[round(r, 2) for r in rates]} "
                f"images/s, median {statistics.median(rates):.2f} | bare step under the same "
                f"gate {BATCH / report['wgrad-cuda'] * 1e3:.2f} images/s | {card}")
        return {"wgrad_mma": mma_launches, "wgrad_fma": fma_launches}
    finally:
        _set_route("aten")
        shutil.rmtree(directory, ignore_errors=True)


# (rows a warp stages per slab, CTAs) of the tensor-core weight-gradient kernel
# (0: the source's choice), for `--wgrad-variants`
WGRAD_VARIANTS = [(0, 0), (16, 132), (16, 264), (16, 396), (16, 528), (32, 132), (32, 264),
                  (32, 396), (32, 528)]


def wgrad_variants(card: str, rounds: int = 2) -> None:
    """``python3 chip_smoke.py --wgrad-variants``: the weight-gradient kernels
    ALONE (`_wgrad_alone_ms`) at the two layers of the envelope in bf16 at
    batch 16: the tensor-core kernel with each (rows per slab, CTAs) of
    WGRAD_VARIANTS, checked against its plain version, and the CUDA-core and
    loads-alone kernels as built, in turns over ``rounds`` rounds."""
    from ssdseglib_torch.ops import pointwise_wgrad as pw

    gen = torch.Generator().manual_seed(4)
    layers = []
    for lead, ci, co in WGRAD_SHAPES[:2]:
        layers.append((f"{ci}->{co}",
                       torch.randn(*lead, ci, generator=gen).to("cuda", torch.bfloat16),
                       torch.randn(*lead, co, generator=gen).to("cuda", torch.bfloat16)))
    for r in range(rounds):
        for rows, ctas in WGRAD_VARIANTS:
            cells = [f"{name} {_wgrad_alone_ms(pw._MMA, x, dy, rows, ctas, check=r == 0):.4f}"
                     for name, x, dy in layers]
            log(f"[wgrad-variants] round {r} mma rows/slab {rows or 'built-in'}, CTAs "
                f"{ctas or 'built-in'}: {' | '.join(cells)} ms, kernel alone | {card}")
        for kernel, label in ((pw._FMA, "fma"), (pw._COPY, "copy")):
            cells = [f"{name} {_wgrad_alone_ms(kernel, x, dy):.4f}" for name, x, dy in layers]
            log(f"[wgrad-variants] round {r} {label} as built: {' | '.join(cells)} ms, kernel "
                f"alone | {card}")


# Candidate (th, tw, EC, NREP) of the bf16 MBConv kernel per width (Cin, E),
# the source's choice first, for `--mbconv-variants`
MBCONV_VARIANTS = {
    (24, 144): [(15, 16, 48, 3), (8, 16, 48, 3), (8, 16, 16, 3), (8, 16, 144, 3),
                (8, 8, 48, 1), (10, 16, 48, 3), (4, 16, 48, 1), (6, 16, 48, 3),
                (15, 16, 16, 3), (15, 8, 48, 3), (8, 20, 48, 3), (12, 20, 48, 3),
                (15, 10, 48, 3)],
    (32, 192): [(10, 20, 48, 4), (6, 20, 48, 4), (6, 16, 48, 2), (6, 16, 48, 4),
                (6, 16, 64, 2), (6, 16, 96, 2), (10, 8, 48, 2), (4, 16, 48, 2),
                (12, 16, 48, 4), (6, 20, 64, 4), (6, 20, 96, 4), (6, 20, 192, 4),
                (12, 20, 48, 4), (5, 20, 48, 4)],
    (64, 384): [(10, 8, 64, 4), (10, 8, 48, 4), (6, 8, 48, 2), (6, 8, 48, 4), (6, 8, 64, 2),
                (6, 8, 96, 2), (5, 8, 48, 2), (6, 10, 48, 4), (3, 8, 48, 2), (10, 8, 96, 4),
                (10, 8, 48, 8), (10, 10, 48, 4), (15, 8, 48, 4), (10, 20, 48, 8)],
    (96, 576): [(10, 8, 64, 6), (10, 8, 48, 6), (6, 8, 48, 3), (6, 8, 48, 6), (6, 8, 64, 3),
                (6, 8, 96, 3), (5, 8, 48, 3), (6, 10, 48, 6), (3, 8, 48, 3), (10, 8, 96, 6),
                (10, 8, 48, 4), (10, 10, 48, 6), (15, 8, 48, 6)],
    (160, 960): [(5, 4, 48, 4), (5, 4, 48, 5), (5, 5, 48, 5), (5, 5, 64, 5), (5, 5, 96, 5),
                 (3, 5, 48, 2), (5, 10, 48, 10), (3, 10, 48, 5), (3, 4, 48, 2),
                 (5, 4, 64, 5), (5, 4, 32, 5), (5, 4, 16, 5), (5, 4, 48, 10), (5, 2, 48, 5)],
}


def mbconv_variants(card: str, rounds: int = 2, launches: int = 20) -> None:
    """``python3 chip_smoke.py --mbconv-variants``: the bf16 MBConv kernel at
    each width of the serving path (batch 16) with each (th, tw, EC, NREP) of
    MBCONV_VARIANTS, ``launches`` launches between two CUDA events, every
    variant first held against the plain version, in turns over ``rounds``
    rounds."""
    from ssdseglib_torch.ops import fused_mbconv as fm

    gen = torch.Generator().manual_seed(0)
    operands = {}
    for cin, h, w, e, _ in MBCONV_SHAPES:
        x, args = _mbconv_operands(gen, torch.bfloat16, cin, h, w, e)
        operands[(cin, e)] = (x, args, fm.fused_mbconv_reference(x, *args))
    for r in range(rounds):
        for (cin, e), configs in MBCONV_VARIANTS.items():
            x, args, want = operands[(cin, e)]
            cells = []
            for config in configs:
                if r == 0:
                    _check_close(f"MBConv Cin={cin} E={e} config {config}",
                                 fm._launch(x, *args, True, config), want,
                                 TOLERANCE[torch.bfloat16])
                for _ in range(3):
                    fm._launch(x, *args, True, config)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(launches):
                    fm._launch(x, *args, True, config)
                end.record()
                end.synchronize()
                cells.append(f"{config} {start.elapsed_time(end) / launches:.4f}")
            log(f"[mbconv-variants] round {r} Cin={cin} E={e} (th, tw, EC, NREP) ms: "
                f"{' | '.join(cells)} | {card}")


# Candidate (tile rows, tile columns at H/4, chunk of block 1's 96 channels,
# warps) of the bf16 stem kernel, the source's choice (0s) first, for
# `--stem-variants`
STEM_VARIANTS = [(0, 0, 0, 0), (15, 16, 32, 16), (15, 16, 96, 16), (15, 16, 48, 8),
                 (12, 16, 48, 16), (10, 16, 48, 16), (20, 16, 48, 16), (15, 20, 48, 16),
                 (8, 16, 48, 8), (8, 16, 32, 8), (8, 16, 16, 8), (8, 16, 48, 16), (6, 16, 48, 8),
                 (8, 32, 48, 16), (4, 16, 48, 8)]


def stem_variants(card: str, rounds: int = 2) -> None:
    """``python3 chip_smoke.py --stem-variants``: the bf16 stem + block 1
    kernel ALONE (20 launches between two CUDA events) at (16, 480, 640, 3)
    with each configuration of STEM_VARIANTS, every one first held against
    the plain version in the kernel's order (the phase-3c gate), in turns
    over ``rounds`` rounds."""
    from ssdseglib_torch.ops import s2d_stem

    gen = torch.Generator().manual_seed(3)
    _, args = _stem_weights(gen, torch.bfloat16)
    x = (torch.rand(BATCH, 480, 640, 3, generator=gen) * 2.0 - 1.0).to("cuda", torch.bfloat16)
    twin = s2d_stem.fused_stem_block1_reference(x, args, k_groups=True)
    runnable = []
    for config in STEM_VARIANTS:
        try:
            resolved = s2d_stem.kernel_config(480, 640, config)
        except RuntimeError:
            log(f"[stem-variants] {config}: does not fit the card (shared memory)")
            continue
        _check_close(f"stem variant {config}", s2d_stem._launch(x, args, config), twin,
                     TOLERANCE[torch.bfloat16])
        runnable.append((config, resolved))
    for r in range(rounds):
        cells = [f"{resolved[:4]} {resolved[4]} B "
                 f"{_events_ms(lambda: s2d_stem._launch(x, args, config)):.4f}"
                 for config, resolved in runnable]
        log(f"[stem-variants] round {r} (tile rows, cols, chunk, warps) shared bytes ms: "
            f"{' | '.join(cells)} | {card}")


# Candidate (tile rows, tile columns) of the chain backward's pass 2, the
# source's choice (0s) first, for `--chain-variants`
CHAIN_VARIANTS = [(0, 0), (8, 32), (16, 16), (8, 16), (6, 32), (4, 32), (10, 32), (24, 16),
                  (12, 32), (4, 64)]


def chain_variants(card: str, rounds: int = 2) -> None:
    """``python3 chip_smoke.py --chain-variants``: the two chain backward
    launches ALONE (20 calls between two CUDA events) at the training path's
    shape in bf16 and f32 with each pass-2 tile (rows, columns) of
    CHAIN_VARIANTS, every one first held against the plain version
    (phase 4's limits), in turns over ``rounds`` rounds."""
    from ssdseglib_torch.ops import fused_chain_backward as fcb

    gen = torch.Generator().manual_seed(1)
    b, h, w, c = BACKWARD_SHAPES[0]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(b, h, w, c, generator=gen) * 2.0).to("cuda", dtype)
        dy = torch.randn(b, h, w, c, generator=gen).to("cuda", dtype)
        weight = (torch.randn(c, 1, 3, 3, generator=gen) * 0.5).to("cuda", dtype)
        gamma = (torch.randn(c, generator=gen) * 0.1 + 1.0).cuda()
        beta = (torch.randn(c, generator=gen) * 0.1).cuda()
        _, u_nchw, mean, var, coefficients = fcb._forward_math(
            x.permute(0, 3, 1, 2), weight, gamma, beta)
        u, taps = u_nchw.permute(0, 2, 3, 1), weight.permute(2, 3, 1, 0)
        want = fcb.dw_bn_relu6_backward_reference(x, u, dy, taps, gamma, beta, mean, var)
        for config in CHAIN_VARIANTS:
            try:
                got = fcb._launch(x, u, dy, taps, coefficients, config)
            except RuntimeError:
                log(f"[chain-variants] {str(dtype)[6:]} {config}: does not fit the card")
                continue
            _check_close(f"chain variant dx {config}", got[0], want[0], TOLERANCE[dtype])
            _check_close(f"chain variant dk {config}", got[1].reshape(3, 3, 1, c), want[1],
                         SUM_TOLERANCE, scale_by_max=True)
            for g, r in zip(got[2].flip(0), want[2:]):
                _check_close(f"chain variant sums {config}", g, r, SUM_TOLERANCE,
                             scale_by_max=True)
            cases.append((dtype, config, (x, u, dy, taps, coefficients), got))
    for r in range(rounds):
        for dtype in (torch.bfloat16, torch.float32):
            cells = [f"{config} {_events_ms(lambda: fcb._launch(*ops, config, out=outs)):.4f}"
                     for dt, config, ops, outs in cases if dt == dtype]
            log(f"[chain-variants] round {r} {str(dtype)[6:]} {(b, h, w, c)} (tile rows, cols) "
                f"ms: {' | '.join(cells)} | {card}")


def ab_arm(card: str) -> None:
    """``python3 chip_smoke.py --ab-arm ROOT``: one arm of `--ab`, on the
    ``ssdseglib_torch`` package under ROOT: at the serving and training
    paths' shapes in bf16, the stem kernel's wrapper and kernel-alone time,
    the six cuDNN convs of the same function, the chain backward's wrapper
    and kernels-alone time and the ATen route of the unit; one JSON line."""
    import torch.nn.functional as F

    from ssdseglib_torch.ops import _cuda_build
    from ssdseglib_torch.ops import fused_chain_backward as fcb
    from ssdseglib_torch.ops import s2d_stem

    lib = _cuda_build.load_library()
    new = hasattr(s2d_stem, "_launch")
    row = {"package": str(_cuda_build._PKG), "card": card}
    gen = torch.Generator().manual_seed(3)
    _, args = _stem_weights(gen, torch.bfloat16)
    x = (torch.rand(BATCH, 480, 640, 3, generator=gen) * 2.0 - 1.0).to("cuda", torch.bfloat16)
    out = torch.empty((BATCH, 120, 160, 24), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def stem_alone():
        if new:
            return s2d_stem._launch(x, args)
        assert lib.stem_block1_launch(1, x.data_ptr(), *(t.data_ptr() for t in args),
                                      out.data_ptr(), BATCH, 480, 640, stream) == 0

    row["stem_ms"] = cuda_median_ms(lambda: s2d_stem.fused_stem_block1(x, args))
    row["stem_alone_ms"] = _events_ms(stem_alone)

    b, h, w, c = BACKWARD_SHAPES[0]
    gen = torch.Generator().manual_seed(1)
    xc = (torch.randn(b, h, w, c, generator=gen) * 2.0).to("cuda", torch.bfloat16)
    dy = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
    weight = (torch.randn(c, 1, 3, 3, generator=gen) * 0.5).to("cuda", torch.bfloat16)
    gamma = (torch.randn(c, generator=gen) * 0.1 + 1.0).cuda()
    beta = (torch.randn(c, generator=gen) * 0.1).cuda()
    forward = fcb._forward_math(xc.permute(0, 3, 1, 2), weight, gamma, beta)
    u, mean, var = forward[1].permute(0, 2, 3, 1), forward[2], forward[3]
    taps = weight.permute(2, 3, 1, 0)
    if new:  # as each tree's autograd unit calls it
        coefficients = forward[4]
        row["chain_ms"] = cuda_median_ms(lambda: fcb.dw_bn_relu6_backward(
            xc, u, dy, taps, gamma, beta, mean, var, coefficients))
        row["chain_alone_ms"] = _events_ms(lambda: fcb._launch(xc, u, dy, taps, coefficients))
    else:
        row["chain_ms"] = cuda_median_ms(lambda: fcb.dw_bn_relu6_backward(
            xc, u, dy, taps, gamma, beta, mean, var))
        # the parent's two C launchers (each pass and its reduction kernel),
        # without the PyTorch operations its wrapper runs between them
        mean32, inv, a_coef, beta32 = fcb._coefficients(gamma, beta, mean, var)
        coef = torch.stack((mean32, inv, a_coef, beta32, a_coef, a_coef))
        taps32 = taps.reshape(9, c).float().contiguous()
        partials = torch.empty((lib.dw_bwd_partial_rows(b, h, w, c), 9, c), device="cuda")
        sums, dk = torch.empty((2, c), device="cuda"), torch.empty((9, c), device="cuda")
        dx = torch.empty_like(xc)

        def chain_alone():
            assert lib.chain_bn_sums_launch(1, *(t.data_ptr() for t in (u, dy, coef, partials,
                                                                        sums)),
                                            b, h, w, c, stream) == 0
            assert lib.chain_backward_launch(1, *(t.data_ptr() for t in (
                xc, u, dy, taps32, coef, dx, partials, dk)), b, h, w, c, stream) == 0

        row["chain_alone_ms"] = _events_ms(chain_alone)
    leaves = [t.detach().requires_grad_() for t in (xc.permute(0, 3, 1, 2), weight, gamma,
                                                    beta)]
    y_aten = F.batch_norm(F.conv2d(leaves[0], leaves[1], None, 1, 1, 1, c), None, None,
                          leaves[2].to(torch.bfloat16), leaves[3].to(torch.bfloat16), True, 0.01,
                          fcb.BN_EPSILON).clamp(0.0, 6.0)
    row["chain_aten_route_ms"] = cuda_median_ms(lambda: torch.autograd.grad(
        y_aten, leaves, dy.permute(0, 3, 1, 2), retain_graph=True))
    print(json.dumps(row), flush=True)


def ab_in_turns(card: str, parent_root: str) -> None:
    """``python3 chip_smoke.py --ab PARENT_ROOT``: `--ab-arm` on the parent's
    package (an unpacked tree at PARENT_ROOT) and on this one, in turns
    (parent, change, change, parent), each arm a process of its own on the
    same card."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    rows = []
    for arm, root in (("parent", parent_root), ("change", here), ("change", here),
                      ("parent", parent_root)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--ab-arm", root],
                              capture_output=True, text=True, check=True)
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append((arm, row))
        log(f"[ab] {arm}: " + " | ".join(f"{k} {v:.4f}" for k, v in row.items()
                                          if isinstance(v, float)) + f" | {row['package']}")
    for key in ("stem_ms", "stem_alone_ms", "chain_ms", "chain_alone_ms"):
        parent = [r[key] for arm, r in rows if arm == "parent"]
        change = [r[key] for arm, r in rows if arm == "change"]
        log(f"[ab] {key}: change / parent = {max(change) / min(parent):.3f} at worst, "
            f"{min(change) / max(parent):.3f} at best | {card}")


def profile_fit(card: str, steps: int = 8) -> None:
    """``python3 chip_smoke.py --profile-fit``: what each stage of a `fit`
    epoch over the loader costs at bf16 b16 (default gates), each timed alone
    over ``steps`` batches: the loader's raw host batches, the pinned upload,
    the transform on the card (host time to enqueue it, and its device time
    by CUDA events), the bare step on a fixed batch, the fused step on
    batches already on the card, and the whole `fit` epoch, staged in chunks
    of 8 as `fit` does and, for comparison, batch by batch."""
    from ssdseglib_torch.boxes import Anchors
    from ssdseglib_torch.config import TrainConfig, reference_warehouse_config
    from ssdseglib_torch.data.pipeline import TrainDataLoader, upload_batch
    from ssdseglib_torch.data.synthetic import generate_dataset
    from ssdseglib_torch.models.builder import SsdSegModel
    from ssdseglib_torch.train import Trainer

    anchors_cfg, enc_cfg, model_cfg, _, _ = reference_warehouse_config()
    anchors = Anchors.from_config(anchors_cfg, enc_cfg.image_shape)
    samples = generate_dataset(FIT_SAMPLES, image_shape=enc_cfg.image_shape,
                               num_classes=enc_cfg.num_classes, seed=0)
    loader = TrainDataLoader(samples * (steps * BATCH // FIT_SAMPLES), anchors, enc_cfg,
                             batch_size=BATCH, augmentation_horizontal_flip=True,
                             augmentation_rgb=True, seed=0)
    trainer = Trainer(model=SsdSegModel(model_cfg, torch.Generator().manual_seed(0)),
                      anchors=anchors,
                      config=TrainConfig(batch_size=BATCH, compute_dtype="bfloat16"))
    state = trainer.init_state(torch.Generator().manual_seed(0))
    device = torch.device("cuda")

    def per_step_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    trainer.fit(state, loader, epochs=1, log_fn=lambda line: None)  # warm-up
    raw = []
    loader_ms = per_step_ms(lambda: raw.extend(loader.iter_raw()))
    assert len(raw) == steps
    staged = []
    upload_ms = per_step_ms(
        lambda: staged.extend((rng, upload_batch(b, device)) for rng, b in raw))
    ready = []
    transform_device_ms = cuda_median_ms(
        lambda: ready.append(loader.transform(staged[0][0], *staged[0][1])), runs=steps)
    del ready[:]
    transform_host_ms = per_step_ms(
        lambda: ready.extend(loader.transform(rng, *batch) for rng, batch in staged))
    images, targets = ready[0]
    step_ms = per_step_ms(lambda: [trainer.train_step(state, images, targets)
                                   for _ in range(steps)])
    fused = trainer.fused_train_step_fn(loader.transform)
    fused_ms = per_step_ms(lambda: [fused(state, rng, *batch) for rng, batch in staged])
    # the whole epoch, staged in chunks of 8 (as `fit` does) and batch by batch
    # (chunks of 1), in turns: 8, 1, 1, 8
    chunked = trainer._staged
    fit_ms = {8: [], 1: []}
    for chunk_size in (8, 1, 1, 8):
        trainer._staged = lambda raw_iter, n=chunk_size: chunked(raw_iter, chunk_size=n)
        fit_ms[chunk_size].append(per_step_ms(
            lambda: trainer.fit(state, loader, epochs=1, log_fn=lambda line: None)))
    trainer._staged = chunked
    log(f"[profile-fit] bf16 b16, {steps} steps, ms per step: loader alone (host batches) "
        f"{loader_ms:.3f} | pinned upload {upload_ms:.3f} | transform alone "
        f"{transform_host_ms:.3f} (its device time {transform_device_ms:.3f}) | bare step on "
        f"one batch {step_ms:.3f} | fused step on uploaded batches {fused_ms:.3f} | fit epoch, "
        f"run in turns: staged in chunks of 8 (as fit does) "
        f"{[round(t, 3) for t in fit_ms[8]]} = "
        f"{[round(BATCH / t * 1e3, 2) for t in fit_ms[8]]} images/s, in chunks of 1 "
        f"{[round(t, 3) for t in fit_ms[1]]} = "
        f"{[round(BATCH / t * 1e3, 2) for t in fit_ms[1]]} images/s, against "
        f"{BATCH / step_ms * 1e3:.2f} for the bare step | {card}")


def _log_device_profile(tag: str, prof, wall_ms: float, steps: int, card: str, own) -> None:
    """Device kernel time by name from a torch.profiler run over ``steps``
    steps: the top 25 kernels and the port's own (names in ``own``)."""
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels.sort(key=lambda row: -row[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    log(f"[profile] {tag}: wall {wall_ms:.3f} ms/step (profiled), device kernel time "
        f"{device_ms:.3f} ms/step, busy share {device_ms / wall_ms:.3f}, "
        f"{sum(n for _, _, n in kernels):.1f} kernels/step | {card}")
    for rank, (name, ms, count) in enumerate(kernels):
        if rank < 25 or any(k in name for k in own):
            log(f"[profile] {ms:8.3f} ms {100 * ms / device_ms:5.1f}% x{count:6.1f}  {name[:110]}")


def profile_serving(card: str, steps: int = 8) -> None:
    """``python3 chip_smoke.py --profile-serve``: where the device time of a
    bf16 b16 serving step goes (torch.profiler over ``steps`` pipelined
    steps, kernel events only) on the default path and on the option path."""
    from torch.profiler import ProfilerActivity, profile

    builder, model, nms = _builder()
    infer = builder.get_model_for_inference(
        model_trained=model, compute_dtype="bfloat16", fused_backbone=True,
        mask_output="bfloat16", device="cuda", **nms)
    make_forward, _, postprocess, _, _ = _option_path_parts()
    option = make_forward(torch.bfloat16, "cuda")

    def serve_option(images):
        out = option(images)
        return out["output-mask"], postprocess(out, "topk")

    inputs, _ = _serving_inputs()
    own = ("mbconv_bf16_kernel", "stem_block1", "nms_scan_kernel")
    for tag, serve in (("default path", infer), ("option path", serve_option)):
        for i in range(3):
            serve(inputs[i])[1].cpu()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            outs = [serve(inputs[i % len(inputs)]) for i in range(steps)]
            outs[-1][1].cpu()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        _log_device_profile(f"serving b16 bf16, {tag}", prof, wall_ms, steps, card, own)


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
    own = ("chain_bwd_kernel", "chain_sums_kernel", "dw_bwd_kernel", "reduce_partials_kernel",
           "wgrad_mma_kernel", "wgrad_fma_kernel", "wgrad_copy_kernel")
    _log_device_profile(f"route {route}", prof, wall_ms, steps, card, own)


def main() -> None:
    if "--ab-arm" in sys.argv:  # the arm's package comes first on the path
        sys.path.insert(0, sys.argv[sys.argv.index("--ab-arm") + 1])
    card = phase_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    if "--profile-serve" in sys.argv:
        profile_serving(card)
        return
    if "--profile-fit" in sys.argv:
        profile_fit(card)
        return
    if "--wgrad-variants" in sys.argv:
        wgrad_variants(card)
        return
    if "--mbconv-variants" in sys.argv:
        mbconv_variants(card)
        return
    if "--stem-variants" in sys.argv:
        stem_variants(card)
        return
    if "--chain-variants" in sys.argv:
        chain_variants(card)
        return
    if "--ab-arm" in sys.argv:
        ab_arm(card)
        return
    if "--ab" in sys.argv:
        ab_in_turns(card, sys.argv[sys.argv.index("--ab") + 1])
        return
    if "--profile-train" in sys.argv:
        routes = [a for a in sys.argv[1:] if a in ROUTES] or list(ROUTES)
        for route in routes:
            profile_training(card, route)
        return
    mbconv = phase_kernel_vs_twin()
    scan = phase_scan_kernel_vs_plain()
    stem = phase_stem_kernel_vs_plain()
    backward = phase_backward_kernels_vs_plain(card)
    wgrad = phase_wgrad_kernels_vs_plain(card, backward["chain_backward"].pop("call"))
    phase_whole_path_parity()
    mbconv["launches"], default_rate = phase_serving(card)
    train_launches = phase_training(card)
    backward["depthwise_backward"]["launches"] = train_launches["depthwise"]
    backward["chain_backward"]["launches"] = train_launches["chain"]
    option_launches = phase_option_path(card, default_rate)
    scan["launches"], stem["launches"] = option_launches["scan"], option_launches["stem"]
    fit_launches = phase_fit(card)
    wgrad["wgrad_mma"]["launches"] = fit_launches["wgrad_mma"]
    wgrad["wgrad_fma"]["launches"] = fit_launches["wgrad_fma"]
    described = {
        "fused_mbconv": ("ssdseglib_torch/csrc/fused_mbconv.cu",
                         "ssdseglib_tpu/ops/fused_mbconv.py:48", mbconv),
        "depthwise_backward": ("ssdseglib_torch/csrc/depthwise_backward.cu",
                               "ssdseglib_tpu/ops/depthwise_backward.py:80",
                               backward["depthwise_backward"]),
        "chain_backward": ("ssdseglib_torch/csrc/fused_chain_backward.cu",
                           "ssdseglib_tpu/ops/fused_chain_backward.py:79",
                           backward["chain_backward"]),
        "nms_scan": ("ssdseglib_torch/csrc/nms_scan.cu",
                     "ssdseglib_tpu/ops/nms_pallas.py:27", scan),
        "stem_block1": ("ssdseglib_torch/csrc/s2d_stem.cu",
                        "ssdseglib_tpu/ops/s2d_stem.py:154", stem),
        "wgrad_mma": ("ssdseglib_torch/csrc/pointwise_wgrad.cu",
                      "tests/tpu_scripts/mosaic_reshape_probe.py:26", wgrad["wgrad_mma"]),
        "wgrad_fma": ("ssdseglib_torch/csrc/pointwise_wgrad.cu",
                      "tests/tpu_scripts/mosaic_reshape_probe.py:80", wgrad["wgrad_fma"]),
        "wgrad_copy": ("ssdseglib_torch/csrc/pointwise_wgrad.cu",
                       "tests/tpu_scripts/mosaic_reshape_probe.py:53", wgrad["wgrad_copy"]),
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
