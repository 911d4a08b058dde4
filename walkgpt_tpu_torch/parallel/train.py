"""The sharded training forward of a dp x tp rank mesh: a rank's share of
the single device's model_forward loss (runtime/train.py's
make_sharded_train_step differentiates it and reduces the gradients).

The JAX package runs model_forward as one program over the mesh and GSPMD
inserts every collective (walkgpt_tpu/runtime/train.py:252-306). Here each
rank (parallel/dist.RankMesh) runs:

  1. the rows: split contiguously over dp, as batch_pspecs splits them:
     dp rank d takes rows [d R/dp, (d + 1) R/dp); R and B must divide by dp;
  2. the frozen SAM encode, without gradients: B / (dp tp) images a rank
     where B divides, else B / dp (replicated over tp), then all-gathered,
     so that every rank holds all B images' features;
  3. the MSQP on all B images and the splice of the rank's rows;
  4. the LLM at num_heads / tp heads on the rank's rows (models/llm.py's
     forward with tp: dist.copy_to at the column-parallel inputs,
     dist.reduce_from at the row-parallel outputs), the token CE's sum over
     the rank's tokens divided by the valid-token count summed over dp;
  5. the [SEG] states: the first max_segs of the rank's rows, all-gathered
     over dp (dist.gather_from, so that each rank's states get their
     gradient back) and compacted to the first max_segs in global
     row-major order, as the single device's nonzero(size=max_segs) gives
     them (dp shards are contiguous row ranges, so their concatenation is
     in row-major order);
  6. the [SEG] head (CTP, InfoNCE over every row, the mask decode, BCE and
     dice over the global num_masks) on the global set, on every rank
     (walkgpt.seg_losses).

The rank's loss is its CE share plus the head's loss over dp, so that the
sum of the ranks' losses over dp is the single device's loss and every
gradient is summed over dp. The reported terms are the global ones. A
[SEG] slot past the valid ones holds another state than the single
device's (which repeats the state at row 0, position 0); both weigh it 0.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.tree import leaves_with_path
from ..models import llm, walkgpt
from ..ops.losses import cross_entropy_sum_count
from . import tp as tpmod
from .dist import gather_from


def check_batch_split(n_rows: int, n_images: int, dp: int) -> None:
    """The batch contract of the sharded step: rows and images split evenly
    over dp (the JAX package's in_shardings refuse the others too)."""
    if n_rows % dp or n_images % dp:
        raise ValueError(f"the sharded train step splits the batch over dp={dp}: {n_rows} "
                         f"rows and {n_images} images must both be multiples of {dp}")


def _features(mesh, params, cfg, images: torch.Tensor) -> torch.Tensor:
    """All B images' SAM features on every rank: each rank encodes its share
    (parallel/tp._pick_encode_shard), the shares gathered over tp and dp."""
    b = int(images.shape[0])
    d, t, dp, tp = mesh.dp_index, mesh.tp_index, mesh.dp, mesh.tp
    with torch.no_grad():
        if tpmod._pick_encode_shard("auto", b, dp, tp):
            n = b // (dp * tp)
            i0 = (d * tp + t) * n
            feats, _ = walkgpt.encode_sam(params, cfg, images[i0:i0 + n])
            feats = mesh.tp_axis.all_gather(feats)
        else:
            n = b // dp
            feats, _ = walkgpt.encode_sam(params, cfg, images[d * n:(d + 1) * n])
        return mesh.dp_axis.all_gather(feats)


def sharded_loss(mesh, params, cfg, batch: Dict[str, torch.Tensor], max_segs: int,
                 remat: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(this rank's loss, the global loss terms as 0-d tensors without
    gradients) of model_forward over the whole batch (module docstring).
    params: the rank's local tree (the LLM its tp shard), cfg the global
    config; batch: runtime/train.BATCH_KEYS as tensors on the rank's device,
    the whole batch on every rank."""
    if any(isinstance(x, torch.Tensor) and x.requires_grad
           for x in leaves_with_path(params["sam"]["image_encoder"]).values()):
        raise NotImplementedError("the sharded train step runs the SAM encoder frozen (the "
                                  "recipe's trainable set never holds it)")
    images, ids, labels = batch["images"], batch["input_ids"], batch["labels"]
    attn, rii = batch["attention_mask"], batch["row_image_idx"]
    n_rows, b = int(ids.shape[0]), int(images.shape[0])
    dp, d = mesh.dp, mesh.dp_index
    check_batch_split(n_rows, b, dp)
    cfg_l = tpmod._local_cfg(cfg, mesh.tp)
    tp_axis = mesh.tp_axis if mesh.tp > 1 else None
    lw = cfg.losses

    feats = _features(mesh, params, cfg, images)
    sam_tokens = feats.reshape(b, -1, feats.shape[-1])
    r = n_rows // dp
    sl = slice(d * r, (d + 1) * r)
    vis_rows = walkgpt.visual_tokens(params, cfg, sam_tokens)[rii[sl]]
    sp = walkgpt.splice_visual(params, cfg, ids[sl], vis_rows, attention_mask=attn[sl],
                               labels=labels[sl])
    hidden, _ = llm.forward(params["llm"], cfg_l.llm, sp.embeds,
                            attention_mask=sp.attention_mask, flash_fn=walkgpt._flash_fn(cfg),
                            remat=remat, tp=tp_axis)
    logits = llm.lm_logits(params["llm"], cfg_l.llm, hidden)
    ce_sum, count = cross_entropy_sum_count(
        logits[:, :-1].reshape(-1, logits.shape[-1]), sp.labels[:, 1:].reshape(-1),
        ignore_index=walkgpt.IGNORE_INDEX, label_smoothing=lw.label_smoothing)
    ce = ce_sum / mesh.dp_axis.psum(count).float().clamp_min(1.0)

    # the rank's first max_segs [SEG] states, gathered over dp and compacted
    seg_mask = walkgpt.seg_timeline_mask(ids[sl], cfg.seg_token_id, cfg)
    idx, valid = walkgpt._first_true(seg_mask.reshape(-1), max_segs)
    states = gather_from(mesh.dp_axis, hidden.reshape(-1, hidden.shape[-1])[idx], 0)
    rows = mesh.dp_axis.all_gather(idx // seg_mask.shape[1] + d * r)
    sel, seg_valid = walkgpt._first_true(mesh.dp_axis.all_gather(valid), max_segs)
    seg_rows = torch.where(seg_valid, rows[sel], 0)
    head = walkgpt.seg_losses(params, cfg, states[sel], seg_valid, seg_rows, feats=feats,
                              sam_tokens=sam_tokens, input_ids=ids, labels=labels,
                              row_image_idx=rii, gt_masks=batch["gt_masks"],
                              pixel_hw=batch["pixel_hw"])
    bce, dice, nce = lw.bce * head.bce, lw.dice * head.dice, lw.nce * head.nce
    loss = lw.ce * ce + (bce + dice + nce) / dp
    with torch.no_grad():
        ce_loss = lw.ce * mesh.dp_axis.psum(ce.detach())
        mask_loss = bce.detach() + dice.detach()
        metrics = dict(loss=ce_loss + mask_loss + nce.detach(), ce_loss=ce_loss,
                       mask_bce_loss=bce.detach(), mask_dice_loss=dice.detach(),
                       nce_loss=nce.detach(), mask_loss=mask_loss)
    return loss, metrics
