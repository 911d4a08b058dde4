"""Host-side image transforms (numpy/PIL) feeding the device pipeline (a copy
of `walkgpt_tpu/data/transforms.py`; PIL is imported by the functions that
resample, so the module imports where PIL is absent).

Numerics match the reference preprocessing:
  * longest/shortest-side resize uses PIL bilinear on uint8 HWC arrays with
    `int(x*scale + 0.5)` target shapes (segment_anything/utils/transforms.py:104-115,
    200-211) — the exact pixels the trained weights saw;
  * `normalize_pad` is PAVEDataset.preprocess (PAVE_dataset.py:115-121):
    (x - mean)/std on raw 0..255 RGB, then bottom/right zero-pad to a square;
  * `resize_nearest` replicates torch F.interpolate(mode="nearest") floor
    indexing for integer label maps (PAVE_dataset.py:278-282).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def get_preprocess_shape(oldh: int, oldw: int, target: int, *,
                         shortest: bool = False) -> Tuple[int, int]:
    side = min(oldh, oldw) if shortest else max(oldh, oldw)
    scale = target * 1.0 / side
    return int(oldh * scale + 0.5), int(oldw * scale + 0.5)


def _pil_resize(image: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """PIL bilinear resize; at the image's own size PIL returns a copy, and so
    does this, without PIL."""
    if tuple(size_hw) == image.shape[:2]:
        return image.copy()
    from PIL import Image
    pil = Image.fromarray(image)
    return np.array(pil.resize((size_hw[1], size_hw[0]), Image.BILINEAR))


def resize_longest_side(image: np.ndarray, target: int) -> np.ndarray:
    """uint8 HWC image -> longest side == target (SAM ResizeLongestSide.apply_image)."""
    return _pil_resize(image, get_preprocess_shape(image.shape[0], image.shape[1], target))


def resize_shortest_side(image: np.ndarray, target: int) -> np.ndarray:
    """uint8 HWC image -> shortest side == target (ResizeShortestSide.apply_image)."""
    return _pil_resize(image, get_preprocess_shape(image.shape[0], image.shape[1],
                                                   target, shortest=True))


def normalize_pad(image: np.ndarray, mean: np.ndarray, std: np.ndarray,
                  square: int) -> np.ndarray:
    """(x - mean)/std then bottom/right zero-pad to (square, square, 3) float32 HWC."""
    x = (image.astype(np.float32) - mean.reshape(1, 1, 3)) / std.reshape(1, 1, 3)
    h, w = x.shape[:2]
    out = np.zeros((square, square, 3), np.float32)
    out[:h, :w] = x
    return out


def resize_nearest(arr: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """torch F.interpolate(mode='nearest') semantics: floor(i * in/out)."""
    h_in, w_in = arr.shape[:2]
    h_out, w_out = size_hw
    rows = np.floor(np.arange(h_out) * (h_in / h_out)).astype(np.int64)
    cols = np.floor(np.arange(w_out) * (w_in / w_out)).astype(np.int64)
    return arr[rows[:, None], cols[None, :]]


def clip_standard_preprocess(image: np.ndarray, size: int,
                             mean=(0.48145466, 0.4578275, 0.40821073),
                             std=(0.26862954, 0.26130258, 0.27577711)) -> np.ndarray:
    """The non-pad CLIPImageProcessor path (configs/preprocessor_448.json semantics):
    shortest-side bicubic resize to `size`, center crop to (size, size),
    rescale 1/255, normalize with CLIP stats. Returns float32 HWC."""
    from PIL import Image
    h, w = image.shape[:2]
    # shortest-edge resize (bicubic, PIL)
    th, tw = get_preprocess_shape(h, w, size, shortest=True)
    pil = Image.fromarray(image).resize((tw, th), Image.BICUBIC)
    x = np.array(pil)
    # center crop
    h2, w2 = x.shape[:2]
    top = (h2 - size) // 2
    left = (w2 - size) // 2
    x = x[top:top + size, left:left + size]
    x = x.astype(np.float32) / 255.0
    return (x - np.array(mean, np.float32)) / np.array(std, np.float32)
