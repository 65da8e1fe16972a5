"""Vision input preprocessing for multimodal calibration and serving.

The port's copy of ``autoawq_tpu/utils/vision_io.py`` (``smart_resize``
:40, ``fetch_image`` :62, ``smart_nframes`` :108, ``fetch_video`` :136,
``process_vision_info`` :205): resolution-constrained resizes with
patch-aligned sides, and images from local paths, PIL images or arrays.
Numpy out ([3, H, W] float32, CLIP normalisation by default), which the
port's vision towers take as tensors. PIL is imported only where an image
is decoded. A ``http(s)`` URL raises: the port downloads nothing, as its
loaders refuse hub ids.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def round_by_factor(x: float, factor: int) -> int:
    return round(x / factor) * factor


def ceil_by_factor(x: float, factor: int) -> int:
    return math.ceil(x / factor) * factor


def floor_by_factor(x: float, factor: int) -> int:
    return math.floor(x / factor) * factor


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = MIN_PIXELS,
                 max_pixels: int = MAX_PIXELS) -> Tuple[int, int]:
    """Pick output (h, w): divisible by ``factor``, total pixels within
    [min_pixels, max_pixels], aspect ratio preserved as closely as possible
    (reference: qwen_vl_utils.py:61)."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"aspect ratio must be < {MAX_RATIO}, got "
            f"{max(height, width) / min(height, width):.1f}")
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, floor_by_factor(height / beta, factor))
        w_bar = max(factor, floor_by_factor(width / beta, factor))
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def fetch_image(image: Any, size: Optional[Tuple[int, int]] = None,
                factor: int = IMAGE_FACTOR,
                normalize: bool = True) -> np.ndarray:
    """path / PIL.Image / array -> float32 [3, H, W]. A ``http(s)`` URL
    raises ValueError (the port downloads nothing)."""
    if isinstance(image, str) and image.startswith(("http://", "https://")):
        raise ValueError(
            f"{image} is a URL: the port reads local images only (fetch "
            "the file first and pass its path)")
    from PIL import Image

    if isinstance(image, np.ndarray):
        img = Image.fromarray(image.astype(np.uint8))
    elif isinstance(image, Image.Image):
        img = image
    elif isinstance(image, str):
        path = image[len("file://"):] if image.startswith("file://") else image
        img = Image.open(path)
    else:
        raise TypeError(f"unsupported image source {type(image)}")
    img = img.convert("RGB")
    if size is None:
        size = smart_resize(img.height, img.width, factor)
    img = img.resize((size[1], size[0]))  # PIL takes (w, h)
    arr = np.asarray(img, np.float32) / 255.0
    if normalize:
        arr = (arr - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)
    return arr.transpose(2, 0, 1).astype(np.float32)


# video sampling constants (reference qwen_vl_utils.py)
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768
VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28


def smart_nframes(ele: Dict[str, Any], total_frames: int,
                  video_fps: float) -> int:
    """Frame count for model input (reference: qwen_vl_utils.py:155):
    either an explicit ``nframes`` or fps-based sampling, rounded to the
    temporal-patch FRAME_FACTOR and bounded by min/max frames."""
    if "fps" in ele and "nframes" in ele:
        raise ValueError("pass either fps or nframes, not both")
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", FPS)
        min_frames = ceil_by_factor(ele.get("min_frames", FPS_MIN_FRAMES),
                                    FRAME_FACTOR)
        max_frames = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
            FRAME_FACTOR)
        nframes = total_frames / video_fps * fps
        nframes = min(min(max(nframes, min_frames), max_frames), total_frames)
        nframes = floor_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes must be in [{FRAME_FACTOR}, {total_frames}], "
            f"got {nframes}")
    return int(nframes)


def fetch_video(ele: Dict[str, Any],
                factor: int = IMAGE_FACTOR,
                normalize: bool = True) -> np.ndarray:
    """Video source -> float32 [T, 3, H, W], fps-sampled and smart-resized
    under the per-video pixel budget (reference: qwen_vl_utils.py:306).

    Accepted ``ele["video"]`` forms (this image has no container decoder —
    no decord/torchvision/av — so compressed files raise with guidance):

    * list of frames (paths / PIL images / arrays) — the reference
      supports this form too; ``ele`` may carry ``fps``/``nframes``
      (list fps defaults to already-sampled, i.e. all frames kept after
      FRAME_FACTOR rounding);
    * ndarray [T, H, W, 3] or [T, 3, H, W] of pre-decoded frames with
      ``video_fps`` metadata for fps-based sampling.
    """
    video = ele["video"]
    if isinstance(video, str):
        raise NotImplementedError(
            "decoding video containers needs decord/torchvision/av (none "
            "installed); pass a list of frames or a pre-decoded [T, H, W, 3]"
            " array instead")

    if isinstance(video, np.ndarray):
        frames = video
        if frames.ndim != 4:
            raise ValueError(
                f"expected [T, H, W, 3] frames, got {frames.shape}")
        if frames.shape[1] == 3 and frames.shape[-1] != 3:
            frames = frames.transpose(0, 2, 3, 1)
        total = frames.shape[0]
        nframes = smart_nframes(ele, total, ele.get("video_fps", FPS))
        idx = np.linspace(0, total - 1, nframes).round().astype(int)
        frames = [frames[i] for i in idx]
    else:  # list/tuple of frame sources
        total = len(video)
        if "nframes" in ele or "fps" in ele:
            nframes = smart_nframes(ele, total, ele.get("video_fps", FPS))
        else:  # frame lists default to keeping (factor-rounded) all frames
            nframes = max(FRAME_FACTOR,
                          floor_by_factor(total, FRAME_FACTOR))
        idx = np.linspace(0, total - 1, nframes).round().astype(int)
        frames = [video[i] for i in idx]

    # per-frame pixel budget from the whole-video budget (reference
    # qwen_vl_utils.py:318-327)
    min_pixels = ele.get("min_pixels", VIDEO_MIN_PIXELS)
    total_pixels = ele.get("total_pixels", VIDEO_TOTAL_PIXELS)
    max_pixels = max(min(VIDEO_MAX_PIXELS,
                         total_pixels / len(frames) * FRAME_FACTOR),
                     int(min_pixels * 1.05))
    max_pixels = min(ele.get("max_pixels", max_pixels), max_pixels)

    first = frames[0]
    h0, w0 = (first.shape[:2] if isinstance(first, np.ndarray)
              else (None, None))
    if h0 is None:
        probe = fetch_image(first, factor=factor, normalize=False)
        h0, w0 = probe.shape[1:]
    if "resized_height" in ele and "resized_width" in ele:
        size = smart_resize(ele["resized_height"], ele["resized_width"],
                            factor)
    else:
        size = smart_resize(h0, w0, factor, min_pixels=min_pixels,
                            max_pixels=int(max_pixels))
    out = np.stack([
        fetch_image(f, size=size, factor=factor, normalize=normalize)
        for f in frames
    ])
    return out.astype(np.float32)


def process_vision_info(
    messages: Sequence[Dict[str, Any]],
    size: Optional[Tuple[int, int]] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Extract and preprocess every image and video from a chat-style
    message list (reference: qwen_vl_utils.py:392). Returns
    (images [3,H,W] each, videos [T,3,H,W] each)."""
    images: List[np.ndarray] = []
    videos: List[np.ndarray] = []
    for msg in messages:
        content = msg.get("content", [])
        if isinstance(content, str):
            continue
        for item in content:
            if item.get("type") == "image" or "image" in item:
                images.append(fetch_image(item.get("image", item.get("url")),
                                          size=size))
            elif item.get("type") == "video" or "video" in item:
                videos.append(fetch_video(item))
    return images, videos
