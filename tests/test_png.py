"""The dependency-free PNG reader/writer (io/png.py)."""

import numpy as np
import pytest

from libviso_tpu.io.png import decode_png, encode_png, read_png_gray, write_png


def _img(kind, rng):
    shape = (37, 53) if kind == "gray" else (37, 53, 3)
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("kind", ["gray", "rgb"])
def test_round_trip_every_filter(kind, filter_type, rng):
    img = _img(kind, rng)
    if filter_type == "mixed":  # all five in one image, row by row
        filter_type = np.arange(img.shape[0]) % 5
    out = decode_png(encode_png(img, filter_type=filter_type))
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, img)


def test_reads_what_pil_writes(tmp_path, rng):
    """Pillow picks its own (adaptive) filters; decoding must match its
    arrays exactly, and RGB -> gray must match convert('L')."""
    Image = pytest.importorskip("PIL.Image")
    for kind in ("gray", "rgb"):
        img = _img(kind, rng)
        p = str(tmp_path / f"{kind}.png")
        Image.fromarray(img).save(p)
        with Image.open(p) as im:
            want = np.asarray(im.convert("L"))
        np.testing.assert_array_equal(read_png_gray(p), want)


def test_pil_reads_what_we_write(tmp_path, rng):
    Image = pytest.importorskip("PIL.Image")
    for kind in ("gray", "rgb"):
        img = _img(kind, rng)
        p = str(tmp_path / f"{kind}.png")
        write_png(p, img)
        with Image.open(p) as im:
            np.testing.assert_array_equal(np.asarray(im), img)


def test_writer_rejects_unknown_filter(rng):
    with pytest.raises(ValueError, match="filter types must be 0-4"):
        encode_png(_img("gray", rng), filter_type=5)
