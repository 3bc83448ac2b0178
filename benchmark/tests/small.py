"""A checkout of the benchmark in a temporary folder with small cells added
as new files and entries (no existing file edited): the two configurations
at 96 x 128 with their anchors' maps cut to match, and the two mixes at
batch 2 (serving) and 4 (training, so that half a batch still holds two
samples a BatchNorm channel).  CPU tests run these through the harness's own path."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from benchmark.harness import catalog

SMALL_MAPS = [[6, 8], [3, 4], [2, 2], [1, 1]]
MIXES = {"serve_small": ("serve_closed_loop_b128", dict(batch=2, pool_batches=2, warmup_batches=2,
                                                  judged_batches=2, trace_seconds=0.5)),
         "train_small": ("train_fit", dict(batch=4, scenes=8, followed_steps=2, trace_epochs=1))}
CELLS = {"mnv2-serve-small": ("mobilenetv2-dlv3p-ssdlite-480x640", "serve_small", "mnv2-serve-b128"),
         "shufflenet-serve-small": ("shufflenetv2-1.5x-dlv3p-ssdlite-480x640", "serve_small",
                                    "shufflenet-serve-b128"),
         "mnv2-train-small": ("mobilenetv2-dlv3p-ssdlite-480x640", "train_small", "mnv2-train-b32")}


def small_config(config: dict) -> dict:
    config = json.loads(json.dumps(config))
    config["name"] += "-small"
    config["model"]["input_image_shape"] = [96, 128, 3]
    config["encoding"]["image_shape"] = [96, 128]
    config["anchors"]["feature_maps_shapes"] = SMALL_MAPS
    return config


def checkout(tmp: Path, limits: dict = None, float32: bool = False) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under ``tmp`` with the small
    cells added; ``limits`` ({cell: {number: limit}}) written as their limit
    files; ``float32``: the small configurations serve and train in f32."""
    root = tmp / "checkout"
    shutil.copytree(catalog.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (root / "benchmark" / "limits").mkdir(exist_ok=True)
    bench = catalog.load_bench()
    for name, (config, mix, like) in CELLS.items():
        entry = next(c for c in bench["configs"] if c["name"] == config)
        small = small_config(json.loads((catalog.ROOT / entry["file"]).read_text()))
        if float32:
            small["serve"].update(compute_dtype="float32", mask_output="float32")
            small["train"]["compute_dtype"] = "float32"
        path = root / "benchmark" / "configs" / f"{small['name']}.json"
        if not path.exists():
            path.write_text(json.dumps(small))
            bench["configs"].append({**entry, "name": small["name"],
                                     "file": f"benchmark/configs/{small['name']}.json"})
        bench["workloads"].append({"name": name, "config": small["name"], "traffic": mix,
                                   "chips": 1, "why": "a small copy for the CPU tests"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if like in metric.get("workloads", []):
                metric["workloads"].append(name)
        if limits and name in limits:
            (root / "benchmark" / "limits" / f"{name}.json").write_text(json.dumps(
                {"numbers": {k: {"limit": v} for k, v in limits[name].items()}}))
    for name, (base, changes) in MIXES.items():
        mix = json.loads((catalog.BENCH_DIR / "traffic" / f"{base}.json").read_text())
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps({**mix, **changes}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def cpu():
    torch.set_num_threads(2)
    return torch.device("cpu")
