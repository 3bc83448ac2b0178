"""A checkout of the benchmark in a temporary folder with small cells added
as new files and entries (no existing file edited): every cell of
``BENCHMARK.json`` gets a copy ``<cell>-small`` on its configuration at
96 x 128, with the anchors' maps cut to match, and on its traffic mix made
small by the mix's driver: batch 2 for serving, 4 for training (so that half
a batch still holds two samples a BatchNorm channel).  CPU tests run these
through the harness's own path."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from benchmark.harness import catalog

SMALL_MAPS = [[6, 8], [3, 4], [2, 2], [1, 1]]
SMALL_MIX = {"serve": dict(batch=2, pool_batches=2, warmup_batches=2, judged_batches=2,
                           trace_seconds=0.5),
             "train": dict(batch=4, scenes=8, followed_steps=2, trace_epochs=1)}


def name(cell: str) -> str:
    """The small copy of ``cell``."""
    return f"{cell}-small"


# small cell: (its configuration's name in BENCHMARK.json, its small mix, the cell it copies)
CELLS = {name(w["name"]): (w["config"], f"{w['traffic']}-small", w["name"])
         for w in catalog.load_bench()["workloads"]}


def small_config(config: dict) -> dict:
    config = json.loads(json.dumps(config))
    config["name"] += "-small"
    config["model"]["input_image_shape"] = [96, 128, 3]
    config["encoding"]["image_shape"] = [96, 128]
    config["anchors"]["feature_maps_shapes"] = SMALL_MAPS
    return config


def small_mix(traffic: str) -> dict:
    mix = json.loads((catalog.BENCH_DIR / "traffic" / f"{traffic}.json").read_text())
    return {**mix, **SMALL_MIX[mix["driver"]]}


def checkout(tmp: Path, limits: dict = None, float32: bool = False) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under ``tmp`` with the small
    cells added; ``limits`` ({cell: {number: limit}}) written as their limit
    files; ``float32``: the small configurations serve and train in f32."""
    root = tmp / "checkout"
    shutil.copytree(catalog.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (root / "benchmark" / "limits").mkdir(exist_ok=True)
    bench = catalog.load_bench()
    for cell, (config, mix, like) in CELLS.items():
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
        bench["workloads"].append({"name": cell, "config": small["name"], "traffic": mix,
                                   "chips": 1, "why": "a small copy for the CPU tests"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if like in metric.get("workloads", []):
                metric["workloads"].append(cell)
        if limits and cell in limits:
            (root / "benchmark" / "limits" / f"{cell}.json").write_text(json.dumps(
                {"numbers": {k: {"limit": v} for k, v in limits[cell].items()}}))
    for w in catalog.load_bench()["workloads"]:
        (root / "benchmark" / "traffic" / f"{w['traffic']}-small.json").write_text(
            json.dumps(small_mix(w["traffic"])))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def add_backbone_copy(root: Path, like: str, backbone: str) -> tuple:
    """Add to the checkout at ``root``, as new files and entries only, a
    backbone ``backbone`` that copies the backbone of ``like``'s
    configuration (its reference and harness files), a small configuration
    that names it, a traffic mix that is ``like``'s small mix with one
    batch in its pool, and two cells on that mix with ``like``'s limits:
    one on the copy, one on the original's small configuration.  With one
    batch in the pool, every judged batch holds the same images, so the
    two cells judge the same work whichever finished batches they keep.
    Returns the two cells' names (copy, original)."""
    bench_dir = root / "benchmark"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = catalog.find_cell(like)
    source = cell.config["model"]["backbone"]
    for folder in ("reference", "harness"):
        shutil.copyfile(bench_dir / folder / "backbones" / f"{source}.py",
                        bench_dir / folder / "backbones" / f"{backbone}.py")
    original = small_config(cell.config)["name"]
    config = json.loads((bench_dir / "configs" / f"{original}.json").read_text())
    config["name"] = f"{backbone}-small"
    config["model"]["backbone"] = backbone
    entry = next(c for c in bench["configs"] if c["name"] == cell.entry["config"])
    (bench_dir / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    bench["configs"].append({**entry, "name": config["name"],
                             "file": f"benchmark/configs/{config['name']}.json"})
    mix = f"{cell.entry['traffic']}-small-one"
    (bench_dir / "traffic" / f"{mix}.json").write_text(
        json.dumps({**small_mix(cell.entry["traffic"]), "pool_batches": 1}))
    names = (f"{backbone}-serve-small", f"{like}-small-one")
    for new, config_name in zip(names, (config["name"], original)):
        bench["workloads"].append({"name": new, "config": config_name, "traffic": mix,
                                   "chips": 1, "why": "a backbone added as new files"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if like in metric.get("workloads", []):
                metric["workloads"].append(new)
        shutil.copyfile(catalog.BENCH_DIR / "limits" / f"{like}.json",
                        bench_dir / "limits" / f"{new}.json")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return names


def cpu():
    torch.set_num_threads(2)
    return torch.device("cpu")
