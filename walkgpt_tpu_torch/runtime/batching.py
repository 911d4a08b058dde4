"""Host-side batch preparation: numpy collate dicts -> fixed-shape arrays for
model_forward / generate_and_segment (a copy of
`walkgpt_tpu/runtime/batching.py`).

Sequence lengths, row counts and seg counts are bucketed here, so a few
shapes serve a whole dataset.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class DeviceBatch:
    images: np.ndarray          # [B, S, S, 3]
    input_ids: np.ndarray       # [R, T]
    labels: np.ndarray          # [R, T]
    attention_mask: np.ndarray  # [R, T] bool
    row_image_idx: np.ndarray   # [R]
    gt_masks: np.ndarray        # [max_segs, S, S] float32 canvas
    pixel_hw: np.ndarray        # [B, 2]
    max_segs: int
    # host-only metadata for eval
    resize_list: list = dataclasses.field(default_factory=list)
    label_shapes: list = dataclasses.field(default_factory=list)
    image_paths: list = dataclasses.field(default_factory=list)


def prepare_batch(batch: Dict, *, img_size: int = 1024, seq_multiple: int = 64,
                  max_segs: int | None = None, seg_multiple: int = 8,
                  images_key: str = "images",
                  seg_token_id: int | None = None,
                  row_multiple: int = 1) -> DeviceBatch:
    """batch: output of data.collate.collate_batch (numpy).

    max_segs is sized from BOTH the GT mask planes and (when seg_token_id is
    given) the actual [SEG] occurrences in input_ids — they can disagree when
    mask files are missing (degenerate PAVE rows).

    row_multiple buckets the conversation-ROW count: the number of rows per
    device batch is data-dependent (images carry 1-5 conversation turns);
    bucketing keeps the eval passes at a few shapes. Pad rows are inert: one live token (id 1) so
    attention has a valid key, labels all -100 (no CE), no [SEG] (no mask
    slots), no image sentinel (splice appends a masked-off visual block),
    row_image_idx 0."""
    input_ids = np.asarray(batch["input_ids"])
    labels = np.asarray(batch["labels"])
    attn = np.asarray(batch["attention_masks"]).astype(bool)
    offset = np.asarray(batch["offset"])
    r, t = input_ids.shape

    # bucket the sequence length
    t_pad = round_up(max(t, 2), seq_multiple)
    def pad_t(a, fill):
        out = np.full((r, t_pad), fill, a.dtype)
        out[:, :t] = a
        return out
    input_ids = pad_t(input_ids, 0)
    labels = pad_t(labels, -100)
    attn = pad_t(attn, False)

    # image row mapping from offsets
    b = len(offset) - 1
    row_image_idx = np.zeros((r,), np.int32)
    for i in range(b):
        row_image_idx[offset[i]:offset[i + 1]] = i

    # bucket the row count (see docstring)
    r_pad = round_up(max(r, 1), row_multiple)
    if r_pad > r:
        def pad_r(a, fill):
            out = np.full((r_pad, t_pad), fill, a.dtype)
            out[:r] = a
            return out
        input_ids = pad_r(input_ids, 0)
        labels = pad_r(labels, -100)
        attn = pad_r(attn, False)
        input_ids[r:, 0] = 1       # one live token per pad row
        attn[r:, 0] = True
        row_image_idx = np.concatenate(
            [row_image_idx, np.zeros((r_pad - r,), np.int32)])

    # GT mask canvas in [SEG]/dataset order: concat per image
    masks_list = batch["masks_list"]
    total = int(sum(m.shape[0] for m in masks_list))
    n_seg_tokens = (int((input_ids == seg_token_id).sum())
                    if seg_token_id is not None else 0)
    ms = (max_segs if max_segs is not None
          else round_up(max(total, n_seg_tokens, 1), seg_multiple))
    gt = np.zeros((ms, img_size, img_size), np.float32)
    k = 0
    for m in masks_list:
        for plane in m:
            if k < ms:
                h, w = plane.shape
                gt[k, :h, :w] = plane
            k += 1

    pixel_hw = np.asarray(batch["resize_list"], np.int64).reshape(b, 2)

    return DeviceBatch(
        images=np.asarray(batch[images_key]),
        input_ids=input_ids, labels=labels, attention_mask=attn,
        row_image_idx=row_image_idx, gt_masks=gt, pixel_hw=pixel_hw,
        max_segs=ms,
        resize_list=list(batch["resize_list"]),
        label_shapes=[np.asarray(l).shape for l in batch["label_list"]],
        image_paths=list(batch.get("image_paths", [])),
    )
