"""Write a synthetic PAVE manifest: the layout `data/pave.PAVEDataset` reads,
with random content drawn from a seed.

    python3 walkgpt_tpu_torch/tools/synthetic_pave.py DIR [--samples 4]
        [--seed 0] [--height 48 --width 64] [--frames]

DIR receives `val.jsonl` (one line per sample: session, index, question(s),
assessment, per-class distances), `labelmap.json` (six classes, three of
them accessible) and, per sample, `{session}/masks/{index}.pt`: an int64
label map at height x width (torch.save) holding several class ids and some
255 (ignore) pixels. With --frames it also writes `{session}/video_frames/
{index}.png` (with cv2); without, the dataset takes its dummy-image path.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch

CLASSES = ("sidewalk", "curb", "crosswalk", "pole", "stairs", "bench")
ACCESSIBILITY = {"sidewalk": 0.9, "curb": 0.2, "crosswalk": 0.8, "pole": 0.1,
                 "stairs": 0.3, "bench": 0.7}
QUESTIONS = ("Is it safe to walk forward?",
             "Which nearby features seem pedestrian-friendly, and which could make "
             "movement unsafe?",
             "Where is the nearest curb?")


def labelmap() -> Dict:
    return {"name_to_id": {n: i + 1 for i, n in enumerate(CLASSES)},
            "id_to_name": {str(i + 1): n for i, n in enumerate(CLASSES)},
            "accessibility_scores": dict(ACCESSIBILITY)}


def write_manifest(root: str, n_samples: int = 4, *, seed: int = 0, height: int = 48,
                   width: int = 64, frames: bool = False, split: str = "val") -> List[dict]:
    """Write the manifest into root; returns its samples."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "labelmap.json"), "w") as f:
        json.dump(labelmap(), f)
    samples = []
    for i in range(n_samples):
        session = os.path.join(root, f"session{i % 2}")
        index = f"{i:05d}"
        os.makedirs(os.path.join(session, "masks"), exist_ok=True)
        ids = rng.choice(len(CLASSES), size=3, replace=False) + 1
        label = rng.choice(ids, size=(height, width)).astype(np.int64)
        label[: height // 4, : width // 4] = 255
        label[-2:, :] = 0
        torch.save(torch.from_numpy(label), os.path.join(session, "masks", f"{index}.pt"))
        if frames:
            import cv2
            os.makedirs(os.path.join(session, "video_frames"), exist_ok=True)
            bgr = rng.randint(0, 256, size=(height, width, 3)).astype(np.uint8)
            cv2.imwrite(os.path.join(session, "video_frames", f"{index}.png"), bgr)
        n_q = 1 + i % 2
        question = ([QUESTIONS[(i + k) % len(QUESTIONS)] for k in range(n_q)]
                    if n_q > 1 else QUESTIONS[i % len(QUESTIONS)])
        samples.append({
            "session": session, "index": index, "question": question,
            "assessment": f"<assessment> Scene {i}: the path ahead is partly "
                          f"blocked. </assessment>",
            "depth": {str(int(c)): round(float(rng.uniform(0.5, 12.0)), 2) for c in ids},
        })
    with open(os.path.join(root, f"{split}.jsonl"), "w") as f:
        for s in samples:
            f.write(json.dumps(s) + "\n")
    return samples


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--frames", action="store_true")
    args = ap.parse_args(argv)
    write_manifest(args.root, args.samples, seed=args.seed, height=args.height,
                   width=args.width, frames=args.frames)
    print(f"wrote {args.samples} samples to {args.root}")


if __name__ == "__main__":
    main()
