"""The port's native loader (`ssdseglib_torch.data.native_loader`, ctypes over
``native/``) against the JAX package's wrapper on the same bytes, and
`HostBatcher`'s native default against its PIL path."""

import io
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

from ssdseglib_tpu.data import native_loader as jax_native
from ssdseglib_torch.data import native_loader
from ssdseglib_torch.data.pipeline import HostBatcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png(arr: np.ndarray, mode: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def _palette_png(arr: np.ndarray, colors: int) -> bytes:
    img = Image.fromarray(arr, mode="P")
    img.putpalette([(37 * i + 11 * c) % 256 for i in range(colors) for c in range(3)])
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _both(name, *args):
    """(port result or error code, JAX result or error code) of ``name``."""
    out = []
    for module in (native_loader, jax_native):
        try:
            out.append(getattr(module, name)(*args))
        except module.NativeLoaderError as e:
            out.append(("error", e.code))
    return out


def _assert_same(ours, theirs):
    if isinstance(ours, tuple) and ours and isinstance(ours[0], np.ndarray):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    elif isinstance(ours, np.ndarray):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    else:
        assert ours == theirs


def _corrupt_ihdr() -> bytes:
    data = bytearray(_png(np.zeros((8, 8, 3), np.uint8), "RGB"))
    data[16:24] = b"\xff" * 8  # width and height 0xFFFFFFFF
    return bytes(data)


def _corrupt_deflate() -> bytes:
    arr = np.random.default_rng(3).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    data = bytearray(_png(arr, "RGB"))
    for i in range(len(data) // 2, len(data) // 2 + 16):
        data[i] ^= 0xFF
    return bytes(data)


def _cases():
    rng = np.random.default_rng(0)
    rgb = _png(rng.integers(0, 256, (37, 53, 3), dtype=np.uint8), "RGB")
    return {
        "rgb": rgb,
        "rgba": _png(rng.integers(0, 256, (24, 40, 4), dtype=np.uint8), "RGBA"),
        "gray": _png(rng.integers(0, 4, (33, 47), dtype=np.uint8), "L"),
        "palette": _palette_png(rng.integers(0, 20, (32, 48), dtype=np.uint8), 20),
        "corrupt-ihdr": _corrupt_ihdr(),
        "corrupt-deflate": _corrupt_deflate(),
        "truncated": rgb[: 8 + 12 + 13],  # header only
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("function", ["png_info", "decode_png_rgb", "decode_png_gray"])
def test_png_functions_equal_the_jax_wrapper(case, function):
    ours, theirs = _both(function, CASES[case])
    _assert_same(ours, theirs)
    if function == "decode_png_rgb" and not isinstance(ours, tuple):
        expected = np.asarray(Image.open(io.BytesIO(CASES[case])).convert("RGB"))
        np.testing.assert_array_equal(ours, expected)
    fails = case == "corrupt-ihdr" or (case in ("corrupt-deflate", "truncated")
                                        and function != "png_info")
    assert (isinstance(ours, tuple) and ours[0] == "error") == fails


@pytest.mark.parametrize("text", [
    b"1,10.5,20.0,30.25,40\r\n3,1,2,3,4\r\n",
    b"1,10,20,30,40",  # no trailing newline
    b"2,1,2,3,4\n\n",
    b"x,1,2,3,4\n",  # a parse error
])
def test_csv_parse_equals_the_jax_wrapper(text):
    ours, theirs = _both("parse_csv", text)
    _assert_same(ours, theirs)


def _write_triples(directory, count, image_shape=(48, 64), seed=2):
    rng = np.random.default_rng(seed)
    h, w = image_shape
    triples = []
    for i in range(count):
        paths = [str(directory / f"{kind}{i}.{ext}")
                 for kind, ext in (("i", "png"), ("m", "png"), ("c", "csv"))]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(paths[0])
        Image.fromarray(rng.integers(0, 4, (h, w), dtype=np.uint8), mode="L").save(paths[1])
        rows = [f"{rng.integers(1, 4)},{rng.uniform(0, 30):.2f},{rng.uniform(0, 20):.2f},"
                f"{rng.uniform(31, 63):.2f},{rng.uniform(21, 47):.2f}"
                for _ in range(int(rng.integers(1, 5)))]
        with open(paths[2], "w") as f:
            f.write("\r\n".join(rows))
        triples.append(tuple(paths))
    return triples


def test_batch_loader_equals_the_jax_batch_loader(tmp_path):
    triples = _write_triples(tmp_path, 5)
    ours = native_loader.NativeBatchLoader((48, 64), max_ground_truth_boxes=8, num_workers=2)
    theirs = jax_native.NativeBatchLoader((48, 64), max_ground_truth_boxes=8, num_workers=2)
    try:
        for a, b in zip(ours.load_batch(triples), theirs.load_batch(triples)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        missing = triples[:1] + [(str(tmp_path / "missing.png"),) + triples[1][1:]]
        with pytest.raises(native_loader.NativeLoaderError) as e:
            ours.load_batch(missing)
        assert e.value.is_io_error and e.value.code in (-30, -31)
    finally:
        ours.close()
        theirs.close()


def test_host_batcher_native_equals_pil_bit_for_bit(tmp_path):
    triples = _write_triples(tmp_path, 7)
    kwargs = dict(batch_size=3, max_ground_truth_boxes=8, shuffle=True, seed=4,
                  image_shape=(48, 64), num_workers=2, use_sample_cache=False,
                  drop_remainder=False)
    native = HostBatcher(triples, **kwargs)
    pil = HostBatcher(triples, use_native=False, **kwargs)
    assert native._native is not None and pil._native is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback warning
        got, want = list(native), list(pil)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_a_batch_the_native_decoder_cannot_take_falls_back_with_one_warning(tmp_path):
    """16-bit masks are outside the native decoder's subset: those batches
    take the PIL path, with one warning for the epoch."""
    triples = _write_triples(tmp_path, 4)
    for _, mask, _ in triples[:2]:
        Image.fromarray(np.asarray(Image.open(mask), np.uint16)).save(mask)  # mode I;16
    kwargs = dict(batch_size=1, max_ground_truth_boxes=8, shuffle=False, image_shape=(48, 64),
                  num_workers=2, use_sample_cache=False)
    with pytest.warns(UserWarning, match="falling back to the PIL path") as caught:
        got = list(HostBatcher(triples, **kwargs))
    assert sum("falling back" in str(w.message) for w in caught) == 1
    want = list(HostBatcher(triples, use_native=False, **kwargs))
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_the_build_uses_the_makefile_s_flags_and_lands_outside_native():
    with open(os.path.join(ROOT, "native", "Makefile")) as f:
        makefile = f.read().splitlines()
    values = {line.split("?=")[0].strip(): line.split("?=")[1].split()
              for line in makefile if "?=" in line}
    assert values == {"CXX": [native_loader.CXX], "CXXFLAGS": list(native_loader.CXXFLAGS),
                      "LDFLAGS": list(native_loader.LDFLAGS)}
    native_loader.get_library()
    path = native_loader.library_path()
    assert path.is_file() and path.parent == native_loader.build_directory() / "native"
    assert os.path.relpath(path, ROOT).startswith(os.path.join("ssdseglib_torch", "build"))


def test_concurrent_builds_are_atomic(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library, and no temporary file is left behind."""
    code = (
        "import sys\n"
        "from ssdseglib_torch.utils.compile_cache import enable_compile_cache\n"
        "enable_compile_cache(sys.argv[1])\n"
        "from ssdseglib_torch.data import native_loader\n"
        "assert native_loader.png_info(sys.stdin.buffer.read()) == (37, 53, 3)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdin=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(4)]
    for proc in procs:
        _, err = proc.communicate(CASES["rgb"], timeout=120)
        assert proc.returncode == 0, err.decode()
    built = os.listdir(tmp_path / "native")
    assert len(built) == 1 and built[0].endswith(".so"), built
