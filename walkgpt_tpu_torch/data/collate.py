"""Batch collation: conversations -> padded token/label arrays + offset
bookkeeping (a copy of `walkgpt_tpu/data/collate.py`).

Behavioral contract follows utils/dataset.py:37-197 (`collate_fn`):
  * per-image conversation lists are flattened; `offset[i]:offset[i+1]` maps
    image i to its conversation rows;
  * `<image>` is wrapped to `<im_start><image><im_end>` when use_mm_start_end;
  * prompts are tokenized with the -200 image sentinel and right-padded;
  * labels mask everything except assistant responses by splitting rounds on
    sep2 ("</s>") and the " ASSISTANT: " separator, with instruction_len-2
    BOS compensation (dataset.py:104-170);
  * train batches truncate to model_max_length - 255 to leave room for the
    255-token image expansion (dataset.py:172-178; SURVEY token invariants).

Note: the reference's `if conv_type == "llava_v1" or "chatml":` is always
truthy (SURVEY WART-6); we implement the *effective* behavior — the llava_v1
separator logic for all non-chatml styles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np

from .conversation import (DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN,
                           DEFAULT_IMAGE_TOKEN, IGNORE_INDEX, conv_templates)
from .tokenizer import tokenizer_image_token


def collate_batch(
    samples: Sequence[Any],
    tokenizer,
    *,
    conv_type: str = "llava_v1",
    use_mm_start_end: bool = True,
) -> Dict[str, Any]:
    image_paths: List[str] = []
    images: List[np.ndarray] = []
    images_clip: List[np.ndarray] = []
    conversations: List[str] = []
    masks_list: List[np.ndarray] = []
    label_list: List[np.ndarray] = []
    resize_list: List[tuple] = []
    clip_resize_list: List[tuple] = []
    questions_list: List[Any] = []
    sampled_classes_list: List[Any] = []
    offsets = [0]
    inferences: List[bool] = []
    cnt = 0

    for s in samples:
        image_paths.append(s.image_path)
        images.append(s.image)
        images_clip.append(s.image_clip)
        conversations.extend(s.conversations)
        masks_list.append(s.masks.astype(np.float32))
        label_list.append(s.label)
        resize_list.append(tuple(s.resize))
        clip_resize_list.append(tuple(s.clip_resize))
        questions_list.append(s.questions)
        sampled_classes_list.append(s.sampled_classes)
        cnt += len(s.conversations)
        offsets.append(cnt)
        inferences.append(bool(getattr(s, "inference", False)))

    if use_mm_start_end:
        rep = DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN
        conversations = [c.replace(DEFAULT_IMAGE_TOKEN, rep) for c in conversations]

    id_rows = [tokenizer_image_token(c, tokenizer, return_np=True)
               for c in conversations]
    max_len = max((len(r) for r in id_rows), default=1)
    pad_id = tokenizer.pad_token_id
    input_ids = np.full((len(id_rows), max_len), pad_id, np.int64)
    for i, r in enumerate(id_rows):
        input_ids[i, :len(r)] = r
    attention_masks = input_ids != pad_id

    targets = input_ids.copy()
    conv = conv_templates.get(conv_type, conv_templates["llava_v1"])

    if conv_type in ("plain", "v0_plain"):
        # LLaVA stage-1 preprocess_plain (train/train.py): supervision starts
        # right after the image part; only the caption (+ trailing sep) is
        # labeled.
        for conversation, target in zip(conversations, targets):
            img_part = conversation.split("\n", 1)[0]
            n = len(tokenizer_image_token(img_part, tokenizer))
            target[:n] = IGNORE_INDEX
        targets[input_ids == pad_id] = IGNORE_INDEX
        sep2 = None           # no round splitting for plain
    else:
        sep2 = conv.sep2 if conv.sep2 else "</s>"

    sep = conv.sep + conv.roles[1] + ": "

    for row, (conversation, target) in enumerate(zip(conversations, targets)):
        if sep2 is None:
            break
        total_len = int((target != pad_id).sum())
        if sep2 not in conversation:
            break
        rounds = conversation.split(sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            if conv_type == "chatml":
                if DEFAULT_IMAGE_TOKEN in conversation:
                    instruction_len = len(tokenizer_image_token(rou + sep, tokenizer)) - 2
                else:
                    instruction_len = len(tokenizer.encode(rou + sep)) - 2
                if i == 0:
                    target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            else:
                parts = rou.split(sep)
                assert len(parts) == 2, (len(parts), rou)
                parts[0] += sep
                if DEFAULT_IMAGE_TOKEN in conversation:
                    round_len = len(tokenizer_image_token(rou, tokenizer))
                    instruction_len = len(tokenizer_image_token(parts[0], tokenizer)) - 2
                else:
                    round_len = len(tokenizer.encode(rou))
                    instruction_len = len(tokenizer.encode(parts[0])) - 2
                target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
                cur_len += round_len
        if conv_type == "chatml":
            cur_len = total_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length:
            assert cur_len == total_len, (cur_len, total_len, conversation)

    inference = inferences[0] if inferences else False
    if not inference:
        truncate_len = tokenizer.model_max_length - 255
        if input_ids.shape[1] > truncate_len:
            input_ids = input_ids[:, :truncate_len]
            targets = targets[:, :truncate_len]
            attention_masks = attention_masks[:, :truncate_len]

    return {
        "image_paths": image_paths,
        "images": np.stack(images, 0),
        "images_clip": np.stack(images_clip, 0),
        "input_ids": input_ids,
        "labels": targets,
        "attention_masks": attention_masks,
        "masks_list": masks_list,
        "label_list": label_list,
        "resize_list": resize_list,
        "clip_resize_list": clip_resize_list,
        "offset": np.asarray(offsets, np.int64),
        "questions_list": questions_list,
        "sampled_classes_list": sampled_classes_list,
        "inference": inference,
        "conversation_list": conversations,
    }
