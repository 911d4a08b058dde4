"""COCO run-length encoding without pycocotools, which the port does not
depend on (a copy of `walkgpt_tpu/data/rle.py`; cv2 is imported only by
`frPyObjects`, which draws polygons).

Implements the two RLE flavors the COCO/refcoco annotation files use:
  * uncompressed: {"counts": [int, ...], "size": [h, w]} — alternating
    background/foreground run lengths in column-major (Fortran) order;
  * compressed: {"counts": bytes/str, "size": [h, w]} — COCO's LEB128-style
    variable-length delta encoding of the counts.

Also `merge` (union) and `area`, used by the AMG utilities.
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def _decode_counts(s: Union[bytes, str]) -> List[int]:
    """COCO compressed counts string -> list of run lengths."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_counts(counts: List[int]) -> bytes:
    out = bytearray()
    for j, x in enumerate(counts):
        if j > 2:
            x -= counts[j - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def decode(rle: Dict) -> np.ndarray:
    """RLE dict -> uint8 mask [h, w]."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _decode_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T          # column-major


def encode(mask: np.ndarray, *, compressed: bool = True) -> Dict:
    """uint8/bool mask [h, w] -> RLE dict."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    # run lengths starting with a (possibly zero-length) background run
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    counts = runs if runs else [h * w]
    if compressed:
        return {"size": [h, w], "counts": _encode_counts(counts)}
    return {"size": [h, w], "counts": counts}


def area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _decode_counts(counts)
    return int(sum(counts[1::2]))


def merge(rles: List[Dict]) -> Dict:
    """Union of masks (refcoco multi-segment objects)."""
    m = decode(rles[0])
    for r in rles[1:]:
        m = np.maximum(m, decode(r))
    return encode(m)


def frPyObjects(obj, h: int, w: int):
    """pycocotools.mask.frPyObjects subset: polygons / uncompressed RLE ->
    compressed RLE (list in, list out)."""
    import cv2
    if isinstance(obj, dict):
        return encode(decode(obj))
    if isinstance(obj, list) and obj and isinstance(obj[0], (list, np.ndarray)):
        out = []
        for poly in obj:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            m = np.zeros((h, w), np.uint8)
            cv2.fillPoly(m, [np.round(pts).astype(np.int32)], 1)
            out.append(encode(m))
        return out
    raise TypeError(f"unsupported segmentation object: {type(obj)}")
