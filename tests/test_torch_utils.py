"""The port's utilities: where compiled code lives (`utils.compile_cache`,
counterpart of the JAX package's persistent compilation cache) and the
profiling helpers (`utils.profiling`)."""

import os
from pathlib import Path

import pytest
import torch

from ssdseglib_torch.data import native_loader
from ssdseglib_torch.ops import _cuda_build
from ssdseglib_torch.utils import compile_cache, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh_cache(monkeypatch):
    """The module's cache setting, restored after the test."""
    monkeypatch.setattr(compile_cache, "_cache_dir", None)


def test_both_builds_default_to_the_package_build_directory(fresh_cache):
    build = os.path.join(ROOT, "ssdseglib_torch", "build")
    assert str(compile_cache.build_directory()) == build
    assert str(_cuda_build.library_path().parent) == build
    assert str(native_loader.library_path().parent) == os.path.join(build, "native")


def test_an_explicit_cache_directory_is_used_as_it_is(fresh_cache, tmp_path):
    wanted = str(tmp_path / "cache")
    assert compile_cache.enable_compile_cache(wanted) == wanted
    assert os.path.isdir(wanted)
    assert str(_cuda_build.library_path().parent) == wanted
    assert str(native_loader.library_path().parent) == os.path.join(wanted, "native")


def test_the_default_cache_is_scoped_to_the_host(fresh_cache):
    used = compile_cache.enable_compile_cache()
    assert used == os.path.join(ROOT, "ssdseglib_torch", "build", "cache",
                                f"host-{compile_cache.host_fingerprint()}")
    assert os.path.isdir(used) and compile_cache.build_directory() == Path(used)
    assert compile_cache.host_fingerprint() == compile_cache.host_fingerprint()
    assert len(compile_cache.host_fingerprint()) == 12


def test_trace_writes_a_trace_and_hands_back_the_profiler(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert any("mm" in event.key for event in prof.key_averages())


def test_time_fn_times_the_card_only():
    if torch.cuda.is_available():
        timing = profiling.time_fn(lambda: torch.ones(8, device="cuda") * 2, steps=4)
        assert timing.steps == 4 and timing.min_s <= timing.p50_s <= timing.p95_s
        assert timing.device == torch.cuda.get_device_name()
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            profiling.time_fn(lambda: None)
    timing = profiling.Timing(mean_s=0.5, p50_s=0.5, p95_s=0.6, min_s=0.4, steps=2,
                              device="card")
    assert timing.throughput(16) == 32.0 and timing.as_dict()["device"] == "card"
