"""The port's vision preprocessing (``autoawq_tpu_torch/utils/vision_io``)
against the JAX package's on the same seeded numpy inputs: sizes, frame
counts and raises exactly; decoded pixels bit for bit (both are the same
numpy and PIL arithmetic). A URL raises in the port (it downloads
nothing)."""

import numpy as np
import pytest

from autoawq_tpu.utils import vision_io as jvio
from autoawq_tpu_torch.utils import vision_io as vio


@pytest.mark.parametrize("hw", [(1000, 700), (10, 10), (28, 28),
                                (4000, 3000), (333, 517), (56, 5000)])
@pytest.mark.parametrize("factor", [14, 28])
def test_smart_resize_equals_jax(hw, factor):
    h, w = vio.smart_resize(*hw, factor=factor)
    assert (h, w) == jvio.smart_resize(*hw, factor=factor)
    assert h % factor == 0 and w % factor == 0
    assert h * w <= vio.MAX_PIXELS
    with pytest.raises(ValueError, match="aspect ratio"):
        vio.smart_resize(10, 4000)


@pytest.mark.parametrize("ele,total,fps", [
    ({}, 120, 30.0), ({"fps": 1.0}, 300, 25.0), ({"nframes": 7}, 40, 10.0),
    ({"min_frames": 6, "max_frames": 10}, 90, 30.0), ({"fps": 4.0}, 10, 2.0),
])
def test_smart_nframes_equals_jax(ele, total, fps):
    assert vio.smart_nframes(ele, total, fps) == \
        jvio.smart_nframes(ele, total, fps)


def test_smart_nframes_refusals():
    with pytest.raises(ValueError, match="either fps or nframes"):
        vio.smart_nframes({"fps": 1, "nframes": 4}, 10, 2.0)
    with pytest.raises(ValueError, match="nframes must be"):
        vio.smart_nframes({"nframes": 40}, 10, 2.0)


def test_fetch_image_and_video_equal_jax():
    pytest.importorskip("PIL")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (60, 80, 3)).astype(np.uint8)
    for kw in (dict(size=(28, 56)), dict(), dict(normalize=False)):
        got = vio.fetch_image(img, **kw)
        np.testing.assert_array_equal(got, jvio.fetch_image(img, **kw))
        assert got.dtype == np.float32
    frames = rng.integers(0, 255, (9, 40, 50, 3)).astype(np.uint8)
    for ele in ({"video": frames, "nframes": 4},
                {"video": list(frames[:5])},
                {"video": frames.transpose(0, 3, 1, 2), "fps": 1.0,
                 "video_fps": 3.0}):
        got = vio.fetch_video(ele)
        np.testing.assert_array_equal(got, jvio.fetch_video(ele))
    with pytest.raises(NotImplementedError, match="pre-decoded"):
        vio.fetch_video({"video": "clip.mp4"})


def test_process_vision_info_equals_jax(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (30, 30, 3)).astype(np.uint8)
    path = str(tmp_path / "img.png")
    PIL.fromarray(img).save(path)
    frames = rng.integers(0, 255, (4, 28, 28, 3)).astype(np.uint8)
    msgs = [{"role": "system", "content": "plain text"},
            {"role": "user",
             "content": [{"type": "text", "text": "hi"},
                         {"type": "image", "image": img},
                         {"image": "file://" + path},
                         {"type": "video", "video": frames}]}]
    imgs, vids = vio.process_vision_info(msgs, size=(28, 28))
    jimgs, jvids = jvio.process_vision_info(msgs, size=(28, 28))
    assert len(imgs) == 2 and len(vids) == 1
    for a, b in zip(imgs + vids, jimgs + jvids):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("url", ["http://example.com/a.png",
                                 "https://example.com/b.jpg"])
def test_a_url_raises(url):
    with pytest.raises(ValueError, match="URL"):
        vio.fetch_image(url)
    with pytest.raises(ValueError, match="URL"):
        vio.process_vision_info([{"content": [{"image": url}]}])
    with pytest.raises(ValueError, match="URL"):
        vio.fetch_video({"video": [url, url]})
