"""The PIL-exact resize's standalone native route (ops/host_build.py builds
cpp/pil_resize.cc alone with g++; ops/pil_resize.py loads it where the libav
decoder library is absent): built into a temporary build directory, it is
bit-equal to the port's numpy route and to the JAX package's on random
frames (downscale, upscale, odd sizes, 1-pixel edges); the loader picks it
when the decoder library is absent, counts the route each call took, and
falls back to numpy when g++ is missing."""

import shutil

import numpy as np
import pytest

from grounded_video_llm_tpu.ops import pil_resize as jresize
from grounded_video_llm_tpu_torch.ops import host_build
from grounded_video_llm_tpu_torch.ops import pil_resize as tresize
from grounded_video_llm_tpu_torch.video.native import decoder as nd

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is needed to build the resize")


@pytest.fixture
def standalone(tmp_path, monkeypatch):
    """The resize's loader with no decoder library and a fresh build root;
    the module's probe is reset before and after."""
    monkeypatch.setattr(nd, "_load", lambda: None)
    monkeypatch.setattr(host_build, "BUILD_ROOT", tmp_path / "host_kernels")
    tresize.reset_native_cache()
    yield tmp_path / "host_kernels"
    monkeypatch.undo()
    tresize.reset_native_cache()


def test_loader_builds_and_picks_the_standalone_library(standalone):
    lib = tresize._native_lib()
    assert lib is not None and tresize.NATIVE_ERROR is None
    so = host_build.library_path(tresize.NATIVE_SOURCE, "gvd_pil_resize")
    assert tresize.NATIVE_LIBRARY == str(so) and so.exists()
    assert so.parent.parent == standalone
    frames = np.zeros((2, 10, 12, 3), np.uint8)
    tresize.resize_bicubic_batch_u8(frames, 7, 5)
    tresize.resize_bicubic_batch_u8(frames, 10, 12)    # no resize at all
    assert tresize.ROUTE_CALLS == {"native": 1, "numpy": 0}


def test_numpy_route_without_gxx(standalone, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert tresize._native_lib() is None
    assert "g++ not found" in tresize.NATIVE_ERROR
    frames = np.random.default_rng(0).integers(0, 256, (1, 9, 7, 3),
                                               dtype=np.uint8)
    out = tresize.resize_bicubic_batch_u8(frames, 4, 5)
    np.testing.assert_array_equal(out[0], jresize._resize_np(frames[0], 4,
                                                             5))
    assert tresize.ROUTE_CALLS == {"native": 0, "numpy": 1}


@pytest.mark.parametrize("hw,out", [
    ((240, 320), (224, 298)),     # the engine's temporal resize
    ((240, 320), (336, 448)),     # its spatial one (an upscale)
    ((61, 83), (17, 129)),        # odd sizes, down one axis and up the other
    ((1, 40), (5, 1)),            # 1-pixel edges
    ((33, 1), (1, 33)),
    ((7, 7), (7, 3))])            # one axis only
def test_native_equals_numpy_routes(standalone, hw, out):
    frames = np.random.default_rng(sum(hw) + sum(out)).integers(
        0, 256, (3, *hw, 3), dtype=np.uint8)
    native = tresize.resize_bicubic_batch_u8(frames, *out)
    assert tresize.ROUTE_CALLS["native"] == 1
    port_np = np.stack([tresize._resize_np(f, *out) for f in frames])
    jax_np = np.stack([jresize._resize_np(f, *out) for f in frames])
    np.testing.assert_array_equal(native, port_np)
    np.testing.assert_array_equal(native, jax_np)
    assert native.shape == (3, *out, 3) and native.dtype == np.uint8


def test_build_hash_follows_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "a.cc"
    src.write_text("int x;\n")
    a = host_build.library_path(src, "a")
    monkeypatch.setattr(host_build, "GXX_FLAGS",
                        host_build.GXX_FLAGS + ("-g",))
    b = host_build.library_path(src, "a")
    src.write_text("int y;\n")
    c = host_build.library_path(src, "a")
    assert len({a.parent, b.parent, c.parent}) == 3
