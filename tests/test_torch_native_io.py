"""The port's binding of the native decoder (``data/native_io.py``) against
PIL, exactly: PNG is lossless, and the JPEG decode links the same libjpeg
as PIL here, as tests/test_native_io.py asserts for the JAX package's
binding.  The library is built from ``native/decoder.cpp`` into
``build/native/`` (never into ``native/``)."""

import os

import numpy as np
import pytest
from PIL import Image

from semi_supervised_semantic_segmentation_tpu_torch.data import native_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand_image(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_library_is_built_into_build_native():
    path = native_io.build()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path).startswith("libsssegio-") and path.endswith(".so")
    assert native_io.SOURCE == os.path.join(REPO, "native", "decoder.cpp")
    assert native_io._load()._name == path
    assert native_io.library_path() == path


def test_png_rgb_decode_matches_pil(tmp_path):
    img = _rand_image(0, 37, 53)
    p = str(tmp_path / "x.png")
    Image.fromarray(img).save(p)
    canvas = np.zeros((64, 64, 3), dtype=np.uint8)
    assert native_io.decode_image_into(p, canvas) == (37, 53)
    np.testing.assert_array_equal(canvas[:37, :53], np.asarray(Image.open(p).convert("RGB")))
    assert canvas[37:].sum() == 0 and canvas[:, 53:].sum() == 0


def test_jpeg_q95_decode_matches_pil(tmp_path):
    p = str(tmp_path / "x.jpg")
    Image.fromarray(_rand_image(1, 40, 56)).save(p, quality=95)
    canvas = np.zeros((64, 64, 3), dtype=np.uint8)
    assert native_io.decode_image_into(p, canvas) == (40, 56)
    np.testing.assert_array_equal(canvas[:40, :56], np.asarray(Image.open(p).convert("RGB")))


@pytest.mark.parametrize("mode", ["P", "L"])
def test_label_decode_reads_palette_indices_and_gray(tmp_path, mode):
    lab = np.random.RandomState(2).randint(0, 21, (30, 31)).astype(np.uint8)
    lab[0, :5] = 255
    im = Image.fromarray(lab, mode=mode)
    if mode == "P":  # VOC: the class id is the palette index
        im.putpalette([c for i in range(256) for c in (i, i // 2, i % 7)])
    p = str(tmp_path / "lab.png")
    im.save(p)
    canvas = np.full((64, 64), 255, dtype=np.int32)
    assert native_io.decode_label_into(p, canvas) == (30, 31)
    np.testing.assert_array_equal(canvas[:30, :31], np.asarray(Image.open(p), np.int32))
    assert (canvas[30:] == 255).all() and (canvas[:, 31:] == 255).all()


def test_threaded_batch_decode_matches_pil(tmp_path):
    paths = []
    for i in range(6):
        p = str(tmp_path / f"{i}.{'png' if i % 2 else 'jpg'}")
        Image.fromarray(_rand_image(3 + i, 20 + i, 25)).save(p, quality=95)
        paths.append(p)
    canvases = np.zeros((6, 32, 32, 3), dtype=np.uint8)
    sizes = np.zeros((6, 2), dtype=np.int32)
    native_io.decode_batch(paths, canvases, sizes, threads=3)
    for i, p in enumerate(paths):
        pil = np.asarray(Image.open(p).convert("RGB"))
        assert tuple(sizes[i]) == pil.shape[:2]
        np.testing.assert_array_equal(canvases[i, :20 + i, :25], pil)


def test_larger_than_canvas_is_cropped(tmp_path):
    img = _rand_image(4, 50, 70)
    p = str(tmp_path / "big.png")
    Image.fromarray(img).save(p)
    canvas = np.zeros((32, 48, 3), dtype=np.uint8)
    assert native_io.decode_image_into(p, canvas) == (32, 48)
    np.testing.assert_array_equal(canvas, img[:32, :48])
    lab = np.random.RandomState(5).randint(0, 19, (50, 70)).astype(np.uint8)
    Image.fromarray(lab, mode="L").save(str(tmp_path / "big_lab.png"))
    lcanvas = np.full((32, 48), 255, dtype=np.int32)
    assert native_io.decode_label_into(str(tmp_path / "big_lab.png"), lcanvas) == (32, 48)
    np.testing.assert_array_equal(lcanvas, lab[:32, :48])


def test_missing_file_raises_ioerror(tmp_path):
    missing = str(tmp_path / "nope.png")
    with pytest.raises(IOError, match="nope.png"):
        native_io.decode_image_into(missing, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(IOError, match="nope.png"):
        native_io.decode_label_into(missing, np.zeros((8, 8), np.int32))
    with pytest.raises(IOError):
        native_io.decode_batch([missing], np.zeros((1, 8, 8, 3), np.uint8),
                               np.zeros((1, 2), np.int32))


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A build that fails raises with the compiler's message: there is no
    fallback decoder."""
    bad = tmp_path / "decoder.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native_io, "SOURCE", str(bad))
    monkeypatch.setattr(native_io, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no_such_header_here"):
        native_io.build()
    assert not os.listdir(tmp_path / "build")
