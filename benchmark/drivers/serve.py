"""Serving driver: one client calls ``InferenceModel.__call__`` on batches of
seeded uint8 scenes in a closed loop, keeping ``in_flight`` batches sent
and not yet fetched, and copies each batch's detections to the host (the
mask stays on the card, as a user who post-processes it there keeps it).
The batch is the mix's: large enough that the card, not the host's
dispatch, sets the pace, so that the rate repeats from run to run.  Each
batch's detections are copied after an event recorded behind its own call,
on a side stream, so the fetch waits for that batch alone and the batches
sent after it keep the card busy while the host stages the next one or
stands still.

Set-up: the scenes (a pool of ``pool_batches`` distinct batches in host
memory), the seeded raw weights on the card, ``get_model_for_inference``
with the configuration's ``serve`` options (the fold happens here), and
``warmup_batches`` calls of the window's own loop, as deep as it runs.
Window: when its time is up nothing more is sent, every batch sent is
fetched, and the clock is read after that: every batch sent counts, over
all of that time.  With a trace, ``trace_seconds`` more of the same loop
run under the profiler, drained inside it.  Judged: a sample of the
batches, drawn from the seed as they are sent, their served mask and
detections against the plain reference's on the same images.
"""

from __future__ import annotations

import gc
import math
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import program, scenes
from benchmark.harness.trace import Spans, profiled
from benchmark.harness.weights import draw
from benchmark.reference import model as ref_model
from benchmark.reference import serve as ref_serve
from benchmark.work import flops, mbconv

FAULTS = ("stale", "half_batch", "altered")


class _Faulty:
    """The program with one planted fault underneath its call (tests and
    calibration only): ``stale`` returns the previous call's outputs (a
    step that returns its state unchanged), ``half_batch`` serves the first
    half of the batch and repeats it (the batch-wide reductions over that
    half), ``altered`` gives the first detection of the first image the
    next class where the detections are produced."""

    def __init__(self, inf, fault: str) -> None:
        self.inf, self.fault, self.last = inf, fault, None

    def __call__(self, images):
        if self.fault == "half_batch":
            half = len(images) // 2
            mask, det = self.inf(images[:half])
            return torch.cat([mask, mask]), torch.cat([det, det])
        mask, det = self.inf(images)
        if self.fault == "altered":
            det = det.clone()
            det[0, 0, 0] = (det[0, 0, 0] + 1) % self.inf.cfg.number_of_classes
        if self.fault == "stale":
            previous, self.last = self.last, (mask, det)
            if previous is not None:
                return previous
        return mask, det


class Session:
    def __init__(self, cell, seed: int, device, log, fault: Optional[str] = None) -> None:
        self.cell, self.seed, self.device, self.log, self.fault = cell, seed, device, log, fault
        self.mix, self.config = cell.mix, cell.config
        self.split: Dict[str, float] = {}

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        mix, config = self.mix, self.config
        t = time.perf_counter()
        hw = tuple(config["encoding"]["image_shape"])
        n = mix["pool_batches"] * mix["batch"]
        images = np.stack([scenes.scene(i, self.seed, hw)[0] for i in range(n)])
        self.pool = [images[i:i + mix["batch"]] for i in range(0, n, mix["batch"])]
        self.split["data generation"] = time.perf_counter() - t

        t = time.perf_counter()
        self.weights = draw(config["model"], self.seed, self.device)
        anchor_set = program.anchors(config)
        build = program.builder(config, anchor_set)
        net = program.network(config, build, self.weights, self.device)
        self.inf = build.get_model_for_inference(net, device=self.device,
                                                 **program.nms_arguments(config), **config["serve"])
        del net
        if self.fault:
            self.inf = _Faulty(self.inf, self.fault)
        self.split["model build and fold"] = time.perf_counter() - t

        t = time.perf_counter()
        self.counts_above = self._boxes_above_threshold()
        self.split["library build or load"] = _library_seconds()
        self.copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._reset(Spans())
        for _ in range(mix["warmup_batches"]):
            self._send(keep=False)
        self._drain(timed=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.split["warm-up"] = time.perf_counter() - t - self.split["library build or load"]
        self.log(f"[serve] boxes above the score threshold {config['nms']['score_threshold']} "
                 f"per batch of {mix['batch']} (before NMS, after the segmentation gating): "
                 f"{self.counts_above}")

    def _boxes_above_threshold(self) -> List[int]:
        inf = self.inf.inf if self.fault else self.inf
        thr = self.config["nms"]["score_threshold"]
        return [int((inf.raw_outputs(b)[1] > thr).sum()) for b in self.pool]

    # -- window -----------------------------------------------------------
    def _reset(self, spans: Spans) -> None:
        self.spans = spans
        self.keep_rng = np.random.default_rng([self.seed, 1])
        self.kept: List = []
        self.pending: deque = deque()
        self.calls = self.done = 0
        self.finished: List[float] = []

    def window(self, seconds: float, trace: bool) -> Dict:
        self._reset(Spans())
        t0 = time.perf_counter()
        self._loop(t0 + seconds)
        self._drain()
        t_end = time.perf_counter()
        images = self.done * self.mix["batch"]
        per_second = np.bincount([int(t - t0) for t in self.finished],
                                 minlength=int(math.ceil(t_end - t0)))
        self.log(f"[serve] images/s in each second of the window (the last after the close, "
                 f"while the batches sent drain): {(per_second * self.mix['batch']).tolist()}")
        out = {"attempted": self.done, "failed": 0, "images_per_s": images / (t_end - t0),
               "spans": self.spans}
        if trace:
            traced = Spans()
            self.spans = traced
            done = self.done
            with profiled(traced) as prof:
                self._loop(time.perf_counter() + self.mix["trace_seconds"])
                self._drain(timed=False)
            timeline = prof["timeline"]
            out["trace"] = {"timeline": timeline, "units": self.done - done, "spans": traced}
        out["metrics"] = {"serve_images_per_s": out["images_per_s"]}
        return out

    def _loop(self, deadline: float) -> None:
        while time.perf_counter() < deadline:
            self._send()
            while len(self.pending) >= self.mix["in_flight"]:
                self._fetch()

    def _send(self, keep: bool = True) -> None:
        """One call on the pool's next batch, an event behind it, and
        whether the reservoir of judged batches (drawn from the seed) keeps
        it: the batch's mask is held only then."""
        index = self.calls
        with self.spans.span("serve.call"):
            mask, det = self.inf(self.pool[index % len(self.pool)])
        ready = None
        if self.copy_stream is not None:
            ready = torch.cuda.Event()
            ready.record()
        slot = None
        k = self.mix["judged_batches"]
        if keep and index < k:
            slot = index
        elif keep:
            j = int(self.keep_rng.integers(0, index + 1))
            slot = j if j < k else None
        self.pending.append((index, mask if slot is not None else None, det, ready, slot))
        self.calls += 1

    def _fetch(self, timed: bool = True) -> None:
        index, mask, det, ready, slot = self.pending.popleft()
        with self.spans.span("serve.fetch"):
            if ready is None:
                host = det.cpu()
            else:
                with torch.cuda.stream(self.copy_stream):
                    self.copy_stream.wait_event(ready)
                    host = det.cpu()
        if timed:
            self.finished.append(time.perf_counter())
        self.done += 1
        if slot is not None:
            if slot < len(self.kept):
                self.kept[slot] = (index, mask, host)
            else:
                self.kept.append((index, mask, host))

    def _drain(self, timed: bool = True) -> None:
        while self.pending:
            self._fetch(timed)

    # -- after the window -------------------------------------------------
    def release(self) -> None:
        """Free the program's state; the judged outputs stay."""
        self.inf = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        net = ref_model.build(self.config["model"], self.weights, self.device)
        _, centroids = ref_serve.anchors(self.config["anchors"], self.config["encoding"]["image_shape"])
        return net, torch.from_numpy(centroids).to(self.device)

    def judge(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared, over the judged batches.  ``control``: the
        reference in fp8 in the program's place (calibration only)."""
        net, centroids = self._reference()
        stds, nms = self.config["encoding"]["standard_deviations"], self.config["nms"]
        totals: Dict[str, list] = {}
        with torch.no_grad():
            for index, mask, det in sorted(self.kept, key=lambda k: k[0]):
                x = torch.from_numpy(self.pool[index % len(self.pool)]).to(self.device).float()
                ref = net(x)
                if control:
                    with ref_model.precision("fp8"):
                        c_mask, c_labels, c_boxes = net(x)
                    det = ref_serve.serve_reference(c_mask, c_labels, c_boxes, centroids, stds, nms)
                    mask = c_mask.to(torch.bfloat16)
                numbers = ref_serve.judge_batch(mask, det.to(self.device), *ref, centroids, stds, nms)
                for k, v in numbers.items():
                    totals.setdefault(k, []).append(v)
        return {"mask_mean_abs": float(np.mean(totals["mask_mean_abs"])),
                "mask_max_abs": max(totals["mask_max_abs"]), "det_gap": max(totals["det_gap"]),
                "det_box_px": max(totals["det_box_px"]), "det_box_rel": max(totals["det_box_rel"]),
                "judged_batches": len(self.kept), "judged_rows": int(sum(totals["rows"]))}

    def work(self) -> Dict[str, float]:
        return {"forward_flops_per_image": flops.forward_flops_per_image(self.config["model"]),
                "mbconv_least_s_per_batch": mbconv.least_seconds(
                    self.mix["batch"], tuple(self.config["encoding"]["image_shape"]))["seconds"],
                "batch": self.mix["batch"]}


def _library_seconds() -> float:
    """nvcc seconds of the program's kernel library in this process (0.0
    when it was loaded from the build directory, or not used)."""
    try:
        from ssdseglib_torch.ops import _cuda_build
    except ImportError:
        return 0.0
    info = _cuda_build.build_info
    return float(info.seconds) if info is not None else 0.0
