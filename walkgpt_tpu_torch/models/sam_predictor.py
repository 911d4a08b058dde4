"""Interactive SAM predictor and automatic mask generator (PyTorch counterpart
of walkgpt_tpu/models/sam_predictor.py: the upstream segment_anything
predictor, automatic_mask_generator and utils/amg subset).

  * SamPredictor encodes an image once (`set_image`, through
    sam_encoder.apply with use_flash=True: K2 in the windowed ViT blocks and
    K3 in the global ones on the GPU, their plain versions on the CPU) and
    decodes point, box and mask prompts against it (`predict`).
  * SamAutomaticMaskGenerator prompts a point grid per crop of a crop
    pyramid, in batches of points_per_batch. Per batch, the masks are
    upsampled, their stability counts taken and the masks binarized on the
    device; the host reads the counts and IoU predictions, applies the two
    thresholds in numpy (the JAX package's comparisons, on the same values),
    and copies only the kept masks. Boxes, NMS, the small-region pass and
    RLE run on the host in numpy.
  * `remove_small_regions` labels components with scipy.ndimage.label under
    8-connectivity in place of cv2.connectedComponentsWithStats, which the
    JAX package calls. The two number components in different orders
    (cv2 by the first 2 x 2 block in raster order, scipy by the first pixel),
    which matters only where every island is small and the largest is kept:
    a tie there goes to the component cv2 would number first.

Entry points run on the CUDA GPU unless the caller passes device="cpu";
params must already lie on that device.
"""
from __future__ import annotations

import dataclasses
import math
from itertools import product
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.tree import resolve_device
from ..data import rle as rle_mod
from ..data import transforms as T
from . import sam as sam_mod
from . import sam_encoder


class SamPredictor:
    def __init__(self, params, cfg: sam_mod.SamConfig, *, device=None):
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.reset_image()

    def reset_image(self):
        self.features = None
        self.original_size: Optional[Tuple[int, int]] = None
        self.input_size: Optional[Tuple[int, int]] = None

    @torch.inference_mode()
    def set_image(self, image: np.ndarray) -> None:
        """image: uint8 RGB HWC."""
        img_size = self.cfg.encoder.img_size
        self.original_size = image.shape[:2]
        resized = T.resize_longest_side(image, img_size)
        self.input_size = resized.shape[:2]
        x = torch.as_tensor(resized, dtype=torch.float32, device=self.device)[None]
        x = sam_mod.preprocess(x, img_size)
        self.features = sam_encoder.apply(self.params["image_encoder"], self.cfg.encoder, x,
                                          use_flash=True)

    def transform_coords(self, coords: np.ndarray) -> np.ndarray:
        oh, ow = self.original_size
        nh, nw = self.input_size
        out = coords.astype(np.float64).copy()
        out[..., 0] *= nw / ow
        out[..., 1] *= nh / oh
        return out

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    @torch.inference_mode()
    def predict(self, *, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True,
                return_logits: bool = False):
        """Single-prompt predict (predictor.py API). Coordinates are in the
        original image frame; mask_input is a [4g, 4g] low-res logit map.
        Returns (masks, iou_predictions, low_res) as numpy arrays."""
        if self.features is None:
            raise RuntimeError("call set_image first")
        points = None
        if point_coords is not None:
            pc = self.transform_coords(point_coords)[None]
            points = (self._tensor(pc), self._tensor(point_labels[None], torch.int32))
        boxes = None
        if box is not None:
            boxes = self._tensor(self.transform_coords(box.reshape(-1, 2)).reshape(1, 4))
        masks_in = None
        if mask_input is not None:
            masks_in = self._tensor(mask_input)[None, ..., None]
        low_res, iou = sam_mod.decode_masks(
            self.params, self.cfg, self.features, points=points, boxes=boxes,
            masks=masks_in, multimask_output=multimask_output)
        masks = sam_mod.postprocess_masks(
            low_res, img_size=self.cfg.encoder.img_size,
            input_size=self.input_size, original_size=self.original_size)[0]
        if not return_logits:
            masks = masks > self.cfg.mask_threshold
        return masks.cpu().numpy(), iou[0].cpu().numpy(), low_res[0].cpu().numpy()


# ---------------------------------------------------------------------------
# AMG utilities (segment_anything utils/amg.py subset)
# ---------------------------------------------------------------------------

def build_point_grid(n_per_side: int) -> np.ndarray:
    offset = 1.0 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    """Per-crop-layer point grids, downscaled by scale_per_layer each layer."""
    return [build_point_grid(max(int(n_per_side / (scale_per_layer ** i)), 1))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float
                        ) -> Tuple[List[List[int]], List[int]]:
    """Crop boxes per pyramid layer: layer i has (2^i)^2 overlapping boxes.
    Returns (XYXY boxes, layer index per box)."""
    crop_boxes, layer_idxs = [[0, 0, im_size[1], im_size[0]]], [0]
    im_h, im_w = im_size
    short_side = min(im_h, im_w)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        crop_w = crop_len(im_w, n_per_side, overlap)
        crop_h = crop_len(im_h, n_per_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_per_side)]
        for x0, y0 in product(x0s, y0s):
            crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def is_box_near_crop_edge(boxes: np.ndarray, crop_box: List[int],
                          orig_box: List[int], atol: float = 20.0) -> np.ndarray:
    """True for boxes that touch the crop boundary but not the image boundary
    (crop artifacts)."""
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    near_crop = np.isclose(boxes, crop[None], atol=atol, rtol=0)
    near_image = np.isclose(boxes, orig[None], atol=atol, rtol=0)
    return (near_crop & ~near_image).any(axis=1)


_EIGHT = np.ones((3, 3), np.int32)


def _first_in_block_order(regions: np.ndarray, labels: np.ndarray) -> int:
    """Of `labels`, the one whose first 2 x 2 block comes first in raster
    order: the one cv2.connectedComponentsWithStats numbers lowest."""
    rr, cc = np.nonzero(np.isin(regions, labels))
    j = np.argmin((rr // 2) * ((regions.shape[1] + 1) // 2) + cc // 2)
    return int(regions[rr[j], cc[j]])


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str
                         ) -> Tuple[np.ndarray, bool]:
    """Remove small disconnected regions ('islands') or fill small holes
    ('holes') via 8-connected components: holes keep the background and
    the small components of the inverted mask, islands the components at
    least area_thresh large (or, where none is, the largest)."""
    from scipy import ndimage
    if mode not in ("holes", "islands"):
        raise ValueError(mode)
    correct_holes = mode == "holes"
    working = correct_holes ^ mask.astype(bool)
    regions, n = ndimage.label(working, structure=_EIGHT)
    sizes = np.bincount(regions.reshape(-1), minlength=n + 1)[1:]
    small = sizes < area_thresh
    if not small.any():
        return mask.astype(bool), False
    keep = np.zeros(n + 1, bool)                 # by label; 0 is the background
    if correct_holes:
        keep[0] = True
        keep[1:] = small
    elif small.all():                            # everything small: keep the largest
        keep[_first_in_block_order(regions, np.flatnonzero(sizes == sizes.max()) + 1)] = True
    else:
        keep[1:] = ~small
    return keep[regions], True


def calculate_stability_score(mask_logits: np.ndarray, mask_threshold: float,
                              offset: float) -> np.ndarray:
    """IoU between high- and low-threshold binarizations."""
    high = (mask_logits > (mask_threshold + offset)).reshape(mask_logits.shape[0], -1).sum(-1)
    low = (mask_logits > (mask_threshold - offset)).reshape(mask_logits.shape[0], -1).sum(-1)
    return high / np.maximum(low, 1)


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] bool -> XYXY boxes (the first row and column a mask
    covers, one past the last); zero box for empty masks."""
    n, h, w = masks.shape
    boxes = np.zeros((n, 4), np.float32)
    rows, cols = masks.any(axis=2), masks.any(axis=1)
    some = rows.any(axis=1)
    xyxy = np.stack([cols.argmax(1), rows.argmax(1), w - cols[:, ::-1].argmax(1),
                     h - rows[:, ::-1].argmax(1)], axis=1)
    boxes[some] = xyxy[some]
    return boxes


def box_nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> List[int]:
    """Greedy NMS (torchvision.ops.nms semantics)."""
    order = np.argsort(-scores)
    keep: List[int] = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a_i + a_r - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return keep


@dataclasses.dataclass
class MaskData:
    rles: List[dict]
    boxes: np.ndarray
    iou_preds: np.ndarray
    stability: np.ndarray
    points: np.ndarray


class SamAutomaticMaskGenerator:
    """Grid-prompted whole-image segmentation, with the multi-crop pyramid
    (crop_n_layers: layer i adds (2^i)^2 overlapping crops, each re-encoded
    and re-prompted) and the small-region pass (hole fill, island removal,
    re-NMS)."""

    def __init__(self, params, cfg: sam_mod.SamConfig, *,
                 points_per_side: int = 32, points_per_batch: int = 64,
                 pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7,
                 crop_n_layers: int = 0,
                 crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 min_mask_region_area: int = 0,
                 device=None):
        self.predictor = SamPredictor(params, cfg, device=device)
        self.cfg = cfg
        self.point_grids = build_all_layer_point_grids(
            points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area

    @torch.inference_mode()
    def _decode_batch(self, pts_in: np.ndarray, crop_hw: Tuple[int, int]):
        """One batch of grid points (input frame) -> the kept masks [K, h, w]
        (bool, host), their IoU predictions and stability scores, and the
        keep flags of all N * 3 masks."""
        pr = self.predictor
        coords = pr._tensor(pts_in)
        labels = torch.ones((coords.shape[0], 1), dtype=torch.int32, device=pr.device)
        low_res, iou = sam_mod.decode_masks(pr.params, self.cfg, pr.features,
                                            points=(coords[:, None, :], labels),
                                            multimask_output=True)
        m = sam_mod.postprocess_masks(low_res, img_size=self.cfg.encoder.img_size,
                                      input_size=pr.input_size, original_size=crop_hw)
        m = m.reshape(-1, *crop_hw)
        thr, off = self.cfg.mask_threshold, self.stability_score_offset
        high = (m > thr + off).flatten(1).sum(-1).cpu().numpy()
        low = (m > thr - off).flatten(1).sum(-1).cpu().numpy()
        i = iou.reshape(-1).cpu().numpy()
        stab = high / np.maximum(low, 1)
        keep = (i > self.pred_iou_thresh) & (stab > self.stability_score_thresh)
        kept = (m[torch.as_tensor(keep, device=m.device)] > thr).cpu().numpy()
        return kept, i[keep], stab[keep], keep, low_res.shape[1]

    def _process_crop(self, image: np.ndarray, crop_box: List[int],
                      layer_idx: int, orig_size: Tuple[int, int]):
        """One crop: encode, grid-prompt, threshold, in-crop NMS, uncrop to
        the full frame."""
        x0, y0, x1, y1 = crop_box
        crop = image[y0:y1, x0:x1]
        ch, cw = crop.shape[:2]
        oh, ow = orig_size
        self.predictor.set_image(crop)
        pts = self.point_grids[layer_idx] * np.array([cw, ch])   # crop frame
        pts_in = self.predictor.transform_coords(pts)

        all_masks, all_iou, all_stab, all_pts = [], [], [], []
        for start in range(0, len(pts_in), self.points_per_batch):
            kept, i, stab, keep, t = self._decode_batch(
                pts_in[start:start + self.points_per_batch], (ch, cw))
            p = np.repeat(pts[start:start + self.points_per_batch], t, axis=0)
            all_masks.append(kept)
            all_iou.append(i)
            all_stab.append(stab)
            all_pts.append(p[keep])
        self.predictor.reset_image()

        if not any(len(m) for m in all_masks):
            return None
        masks_c = np.concatenate(all_masks, 0)
        ious = np.concatenate(all_iou, 0)
        stabs = np.concatenate(all_stab, 0)
        points = np.concatenate(all_pts, 0) + np.array([x0, y0])  # uncrop

        if (ch, cw) == (oh, ow):
            masks = masks_c
        else:
            masks = np.zeros((masks_c.shape[0], oh, ow), bool)
            masks[:, y0:y1, x0:x1] = masks_c
        boxes = batched_mask_to_box(masks)
        # drop masks whose box touches the crop edge but not the image edge
        edge = is_box_near_crop_edge(boxes, crop_box, [0, 0, ow, oh])
        if edge.any():
            keep = ~edge
            masks, ious, stabs = masks[keep], ious[keep], stabs[keep]
            points, boxes = points[keep], boxes[keep]
        if len(masks) == 0:
            return None
        # in-crop NMS by predicted IoU
        keep = box_nms(boxes, ious, self.box_nms_thresh)
        crop_area = float((x1 - x0) * (y1 - y0))
        return MaskData(
            rles=[None] * len(keep),       # encoded at the end
            boxes=boxes[keep], iou_preds=ious[keep], stability=stabs[keep],
            points=points[keep]), masks[keep], crop_area

    def generate(self, image: np.ndarray) -> List[dict]:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio)

        masks_l, ious_l, stabs_l, pts_l, boxes_l, crop_a = [], [], [], [], [], []
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            res = self._process_crop(image, crop_box, layer_idx, orig_size)
            if res is None:
                continue
            data, masks, area = res
            masks_l.append(masks)
            ious_l.append(data.iou_preds)
            stabs_l.append(data.stability)
            pts_l.append(data.points)
            boxes_l.append(data.boxes)
            crop_a.append(np.full((len(masks),), area))
        if not masks_l:
            return []
        masks = np.concatenate(masks_l, 0)
        ious = np.concatenate(ious_l, 0)
        stabs = np.concatenate(stabs_l, 0)
        points = np.concatenate(pts_l, 0)
        boxes = np.concatenate(boxes_l, 0)
        crop_areas = np.concatenate(crop_a, 0)

        # cross-crop dedup preferring masks from smaller crops
        if len(crop_boxes) > 1:
            keep = box_nms(boxes, 1.0 / crop_areas, self.crop_nms_thresh)
            masks, ious, stabs = masks[keep], ious[keep], stabs[keep]
            points, boxes = points[keep], boxes[keep]

        # small-region pass: fill holes, drop islands, re-NMS preferring
        # untouched masks
        if self.min_mask_region_area > 0 and len(masks):
            changed_scores = np.ones((len(masks),), np.float32)
            for k in range(len(masks)):
                m, ch1 = remove_small_regions(masks[k], self.min_mask_region_area, "holes")
                m, ch2 = remove_small_regions(m, self.min_mask_region_area, "islands")
                masks[k] = m
                if ch1 or ch2:
                    changed_scores[k] = 0.0
            boxes = batched_mask_to_box(masks)
            keep = box_nms(boxes, changed_scores,
                           max(self.box_nms_thresh, self.crop_nms_thresh))
            masks, ious, stabs = masks[keep], ious[keep], stabs[keep]
            points, boxes = points[keep], boxes[keep]

        out = []
        for k in range(len(masks)):
            area = int(masks[k].sum())
            if area == 0:
                continue
            out.append({
                "segmentation": rle_mod.encode(masks[k].astype(np.uint8)),
                "area": area,
                "bbox": boxes[k].tolist(),
                "predicted_iou": float(ious[k]),
                "stability_score": float(stabs[k]),
                "point_coords": [points[k].tolist()],
            })
        return out
