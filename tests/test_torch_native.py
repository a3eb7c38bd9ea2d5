"""The port's host resize library (transformerupscaler_torch/native.py, its
own copy of native/resize.cpp) against the JAX package's
(transformerupscaler_tpu/native.py): bit for bit on down- and up-sizes, in
uint8 and in float32; and no fallback: a library that does not build or a
resize that returns an error raises."""

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from transformerupscaler_torch import native

SIZES = [((240, 320), (120, 160)), ((240, 320), (480, 640)),
         ((720, 1280), (97, 131)), ((33, 47), (1080, 1920)),
         ((1080, 1920), (720, 1280))]


@pytest.fixture(scope="module")
def jax_native():
    from transformerupscaler_tpu import native as jax_native_mod

    if not jax_native_mod.available():
        pytest.skip("the JAX package's native library does not build here")
    return jax_native_mod


@pytest.mark.parametrize("src_hw,out_hw", SIZES)
def test_resize_is_jax_bit_for_bit(jax_native, src_hw, out_hw):
    src = np.random.default_rng(0).integers(0, 256, (*src_hw, 3), np.uint8)
    before = dict(native.CALLS)
    got = native.resize_bilinear_u8(src, out_hw)
    assert got.shape == (*out_hw, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got,
                                  jax_native.resize_bilinear_u8(src, out_hw))
    f = native.resize_to_model_input(src, out_hw)
    assert f.dtype == np.float32
    np.testing.assert_array_equal(
        f, jax_native.resize_to_model_input(src, out_hw))
    assert native.CALLS["resize_bilinear_u8"] == \
        before["resize_bilinear_u8"] + 1
    assert native.CALLS["resize_to_model_input"] == \
        before["resize_to_model_input"] + 1


def test_library_is_built_in_the_port_build_dir():
    native.load()
    path = native.lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert "build" in path.parts and "native" not in path.parts[:-2]
    info = native.build_info()
    assert info["compiler"] in native.compilers()
    assert info["openmp"] == ("-fopenmp" in info["flags"])


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that no compiler builds raises with each attempt's output
    (with and without OpenMP); a compiler that is not there is one of
    them."""
    bad = tmp_path / "resize.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no compiler builds") as err:
        native.resize_bilinear_u8(np.zeros((8, 8, 3), np.uint8), (4, 4))
    msg = str(err.value)
    assert "cannot run" in msg and "-fopenmp" in msg
    assert msg.count("failed (") == 2 * (len(native.compilers()) - 1)
    with pytest.raises(RuntimeError, match="no compiler builds"):
        native.resize_to_model_input(np.zeros((8, 8, 3), np.uint8), (4, 4))
    assert native._lib is None and not list(tmp_path.rglob("*.so"))


def test_build_without_openmp_where_no_compiler_has_it(tmp_path,
                                                       monkeypatch):
    """A compiler that refuses -fopenmp (no libgomp): the library builds
    without it and resizes alike."""
    wrapper = tmp_path / "cxx-no-openmp"
    wrapper.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] '
                       '&& { echo "cannot read spec file libgomp.spec" >&2; '
                       'exit 1; }; done\nexec g++ "$@"\n')
    wrapper.chmod(0o755)
    src = np.random.default_rng(1).integers(0, 256, (40, 60, 3), np.uint8)
    want = native.resize_bilinear_u8(src, (17, 23))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "compilers", lambda: [str(wrapper)])
    np.testing.assert_array_equal(native.resize_bilinear_u8(src, (17, 23)),
                                  want)
    assert native.build_info() == dict(
        compiler=str(wrapper), openmp=False,
        flags=[f for f in native.CXX_FLAGS if f != "-fopenmp"])


def test_resize_error_raises():
    """The library refuses more than 16 channels (returns 1): raised, not
    papered over."""
    with pytest.raises(RuntimeError, match="returned 1"):
        native.resize_bilinear_u8(np.zeros((8, 8, 17), np.uint8), (4, 4))
    with pytest.raises(ValueError, match="HWC"):
        native.resize_bilinear_u8(np.zeros((8, 8), np.uint8), (4, 4))
