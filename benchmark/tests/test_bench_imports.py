"""Nothing the benchmark runs loads JAX or the JAX package: a run of a small
cell in a fresh process, then ``sys.modules`` by whole top-level names."""

import json
import subprocess
import sys
import textwrap

from benchmark.harness import catalog, cli

SCRIPT = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    import torch
    torch.set_num_threads(2)
    from benchmark.harness import catalog, cli
    cell = catalog.find_cell({cell!r}, __import__("pathlib").Path({checkout!r}))
    for name in {names!r}:
        catalog.find_cell(name).driver(), catalog.find_cell(name).readers()
    import benchmark.calibrate, benchmark.reference.train, benchmark.work.flops
    cli.run(cell, 9, 0.2, False, torch.device("cpu"), 0.0, out=lambda line: None)
    print(json.dumps({{"forbidden": cli.forbidden_modules(),
                      "port": "ssdseglib_torch" in sys.modules}}))
""")


def test_a_run_loads_no_jax(tmp_path):
    from benchmark.tests import small

    checkout = small.checkout(tmp_path)
    names = [w["name"] for w in catalog.load_bench()["workloads"]]
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(
        root=str(catalog.ROOT), checkout=str(checkout), cell=small.name("mnv2-serve-b128"),
        names=names)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen == {"forbidden": [], "port": True}


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ssdseglib", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    found = cli.forbidden_modules()
    assert "ssdseglib" in found and "jaxlib" in found and "ssdseglib_torch" not in found
