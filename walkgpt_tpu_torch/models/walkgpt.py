"""WalkGPT grounded-navigation inference and training (PyTorch counterpart
of walkgpt_tpu/models/walkgpt.py).

    SAM ViT encode ─┬─> MSQP -> 6x6 tokens -> bilinear 16x16 -> splice at <image>
                    │      -> LLaMA prefill (K1) + greedy decode
                    │      -> [SEG] predictor hidden states -> CTP
                    └──────────────────────────> SAM prompt encoder + mask decoder

The entry points (`init`, `init_quantized`, `generate_and_segment`) run on
CUDA unless the caller passes another device. Besides dense weights, the
quantized production formats run: W8A8 or packed-int4 LLM weights
(`init_quantized`), int8 SAM encoder blocks, and every KV cache but the
growing one: the flat int8 / packed int4 caches (cfg.kv_quant_cache
"int8_flat" / "int4_flat"), the heads-layout int8 / int4 caches ("int8" /
True / "int4") and the flat bf16 cache (cfg.llm.fused_decode). Decode is
greedy or speculative (`speculative_k`).

Training: `model_forward` is the teacher-forced forward with the losses
(token CE, mask BCE and dice, InfoNCE) that runtime/train.py differentiates;
the LLM's attention runs K1 with its backward K1b.

Manual dp x tp inference (parallel/tp.py): `generate_seg_embeds` and
`teacher_seg_embeds` with `tp` are a rank's half of the sharded generation
and teacher-forced passes; the rank with the gathered [SEG] embeddings
decodes the masks (`decode_seg_masks`). The GSPMD leg (parallel/infer.
make_sharded_generate) runs the same two with a parallel/gspmd.GspmdAxis
as `tp`, and `encode_sam` and `clip_visual_tokens` with it split the towers.

The CLIP visual stream (`generate_and_segment(visual_stream="clip")`): the
CLIP-448 pixels go through the CLIP tower (models/clip_vit.py, plain
attention as in the JAX package) and the mm_projector, are bilinearly
downsampled to the visual grid and spliced with their padding mask; the
masks still decode against the SAM features.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core import nn
from ..core.config import WalkGPTConfig
from ..core.tree import leaves_with_path, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.losses import cross_entropy_with_smoothing, infonce_loss
from ..ops.quant import quantize_sam_encoder, quantized_llm_init
from ..ops.resize import bilinear_resize
from ..runtime.generate import GenerateResult, greedy_generate, speculative_generate
from . import clip_vit, llm, sam
from .projectors import ctp_apply, ctp_init, msqp_apply, msqp_init, tiny_xattn_init

IMAGE_TOKEN_INDEX = -200
IGNORE_INDEX = -100


def sam_config(cfg: WalkGPTConfig) -> sam.SamConfig:
    return sam.SamConfig(encoder=cfg.sam, prompt=cfg.prompt_encoder,
                         decoder=cfg.mask_decoder)


def init(cfg: WalkGPTConfig, *, seed: int = 0, dtype=torch.float32, device=None,
         llm_init=None) -> Dict:
    """Random parameters with the JAX package's tree layout, built leaf by
    leaf on `device` (default CUDA) from a seeded torch.Generator.
    llm_init(g, cfg.llm, dtype), when given, builds the LLM subtree. With
    cfg.clip set, the CLIP tower and the CLIP->LLM mm_projector are drawn
    after every other leaf, so those keep their values for a given seed."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = {
        "llm": (llm_init or llm.init)(g, cfg.llm, dtype),
        "sam": sam.init(g, sam_config(cfg), dtype),
        "msqp": msqp_init(g, cfg.msqp, cfg.llm.hidden_size, dtype),
        "ctp": [ctp_init(g, cfg.ctp, cfg.llm.hidden_size, dtype)],
        "tiny_xattn": tiny_xattn_init(g, cfg.msqp.sam_dim, dtype),
    }
    if cfg.clip is not None:
        params["clip"] = clip_vit.init(g, cfg.clip, dtype)
        # the CLIP->LLM projector of the LLaVA layer (llava_arch.py:30-88)
        params["mm_projector"] = nn.linear_init(g, cfg.clip.hidden_size,
                                                cfg.llm.hidden_size, dtype=dtype)
    return params


def init_quantized(cfg: WalkGPTConfig, *, seed: int = 0, dtype=torch.bfloat16,
                   device=None, act_quant: bool = False, sam_int8: bool = False,
                   mlp_int4: bool = False, attn_int4: bool = False,
                   attn_int4_proj: bool = False, head_int4: bool = False,
                   quantize_lm_head: bool = True) -> Dict:
    """`init`'s layout with a quantized LLM built one layer at a time on the
    device (ops/quant.quantized_llm_init): act_quant marks the int8
    projections W8A8, mlp_int4 / attn_int4 / head_int4 pack the MLPs, the
    fused q/k/v and the lm_head as int4, attn_int4_proj each attention
    projection on its own; quantize_lm_head=False keeps a dense head.
    sam_int8 quantizes the SAM encoder blocks' projections (W8A8 with
    act_quant). The CLIP tower and the mm_projector stay as `init` builds
    them.

    WalkGPT-7B's production format: act_quant, mlp_int4, attn_int4,
    head_int4 and sam_int8 (with kv_quant_cache "int4_flat"); WalkGPT-1B's:
    act_quant and sam_int8 (with "int8_flat")."""
    def llm_init(g, llm_cfg, dt):
        return quantized_llm_init(g, llm_cfg, dt, act_quant=act_quant, mlp_int4=mlp_int4,
                                  attn_int4=attn_int4, attn_int4_proj=attn_int4_proj,
                                  head_int4=head_int4, quantize_lm_head=quantize_lm_head)
    params = init(cfg, seed=seed, dtype=dtype, device=device, llm_init=llm_init)
    if sam_int8:
        params["sam"] = quantize_sam_encoder(params["sam"], act_quant=act_quant)
    return params


# ---------------------------------------------------------------------------
# vision encoding
# ---------------------------------------------------------------------------

def encode_sam(params, cfg: WalkGPTConfig, images: torch.Tensor, tp=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, S, S, 3] -> (feature maps [B, g, g, C], tokens [B, g*g, C]).
    sam_encode_chunk > 0 encodes sub-batches one after the other;
    fast_windowed_attention selects the einsum attention's fast branch in
    the windowed blocks (the kernels' route, use_flash_attention, ignores
    it, as in the JAX package). tp: a rank of the GSPMD leg."""
    def enc(im):
        return sam.encode_image(params["sam"], sam_config(cfg), im,
                                use_flash=cfg.use_flash_attention,
                                fast_windowed=cfg.fast_windowed_attention,
                                fast_gelu=cfg.fast_gelu, tp=tp)
    b = images.shape[0]
    ch = cfg.sam_encode_chunk
    if ch and b > ch and b % ch == 0:
        feats = torch.cat([enc(images[i:i + ch]) for i in range(0, b, ch)], dim=0)
    else:
        feats = enc(images)
    _, g1, g2, c = feats.shape
    return feats, feats.reshape(b, g1 * g2, c)


def visual_tokens(params, cfg: WalkGPTConfig, sam_tokens: torch.Tensor) -> torch.Tensor:
    """SAM grid tokens [B, L, C] -> spliceable LLM tokens [B, V, H]: MSQP to
    an s x s grid, then bilinear to the visual grid."""
    vis = msqp_apply(params["msqp"], cfg.msqp, sam_tokens)
    s = cfg.msqp.target_square_side
    t = cfg.visual_grid
    b, _, h = vis.shape
    grid = bilinear_resize(vis.reshape(b, s, s, h), (t, t))
    return grid.reshape(b, t * t, h)


class Spliced(NamedTuple):
    embeds: torch.Tensor          # [R, T-1+V, H]
    attention_mask: torch.Tensor  # [R, T-1+V] bool
    image_pos: torch.Tensor       # [R] index of the <image> sentinel
    labels: Optional[torch.Tensor] = None   # [R, T-1+V] when labels are given


def _splice_block(embeds: torch.Tensor, sentinels: torch.Tensor, attn: torch.Tensor,
                  labels: Optional[torch.Tensor], vis: torch.Tensor,
                  vis_mask: Optional[torch.Tensor] = None):
    """Expand the FIRST sentinel of each row of an embedding timeline with the
    visual block `vis` [R, V, H] (+V-1 net growth). `sentinels` is a bool
    [R, T] map; rows with no sentinel get the block at their first pad slot
    with attention masked off, so no real token leaves the timeline.
    Inside the block labels are IGNORE_INDEX, and attention is the row's
    having a sentinel, and with vis_mask [R, V] the visual token's validity.
    Returns (embeds', sentinels', attn', labels', image_pos)."""
    r, t, hd = embeds.shape
    v = vis.shape[1]
    out_len = t - 1 + v
    has_img = sentinels.any(dim=1)
    pos = torch.where(has_img, sentinels.int().argmax(dim=1),
                      attn.long().sum(-1).clamp_max(t - 1))
    j = torch.arange(out_len, device=embeds.device)[None]
    p = pos[:, None]
    before = j < p
    inside = (j >= p) & (j < p + v)
    tok_idx = torch.where(before, j, j - (v - 1)).clamp(0, t - 1)
    vis_idx = (j - p).clamp(0, v - 1)
    g_tok = torch.gather(embeds, 1, tok_idx[..., None].expand(r, out_len, hd))
    g_vis = torch.gather(vis.to(g_tok.dtype), 1, vis_idx[..., None].expand(r, out_len, hd))
    embeds2 = torch.where(inside[..., None], g_vis, g_tok)
    vis_ok = has_img[:, None]
    if vis_mask is not None:
        vis_ok = vis_ok & torch.gather(vis_mask.bool(), 1, vis_idx)
    attn2 = torch.where(inside, vis_ok, torch.gather(attn, 1, tok_idx))
    sent2 = torch.where(inside, False, torch.gather(sentinels, 1, tok_idx))
    labels2 = None
    if labels is not None:
        labels2 = torch.where(inside, IGNORE_INDEX, torch.gather(labels, 1, tok_idx))
    return embeds2, sent2, attn2, labels2, pos


def splice_visual(params, cfg: WalkGPTConfig, input_ids: torch.Tensor,
                  vis_tokens: torch.Tensor,
                  attention_mask: Optional[torch.Tensor] = None,
                  labels: Optional[torch.Tensor] = None,
                  vis_mask: Optional[torch.Tensor] = None, tp=None) -> Spliced:
    """Replace each row's <image> sentinel by the V visual tokens (+V-1 net
    growth). Rows without a sentinel get the block appended at their first
    pad slot with attention masked off (text-only rows). labels [R, T],
    when given, follow the tokens; inside the visual block they are
    IGNORE_INDEX. vis_mask [R, V] (optional): per-visual-token validity,
    the CLIP pixel path's padding mask on the visual grid
    (vit_attention_mask_for_llm, llava_arch.py:176-181), masking padded
    patch positions out of attention. tp: the embedding lookup of a rank of
    the GSPMD leg (llm.embed)."""
    r, t = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((r, t), dtype=torch.bool, device=input_ids.device)
    embeds, _, attn, labels_out, pos = _splice_block(
        llm.embed(params["llm"], input_ids.clamp_min(0), tp), input_ids == IMAGE_TOKEN_INDEX,
        attention_mask, labels, vis_tokens, vis_mask)
    return Spliced(embeds=embeds, attention_mask=attn, image_pos=pos, labels=labels_out)


def splice_visual_multi(params, cfg: WalkGPTConfig, input_ids: torch.Tensor,
                        vis_tokens: torch.Tensor,
                        attention_mask: Optional[torch.Tensor] = None,
                        labels: Optional[torch.Tensor] = None) -> Spliced:
    """Multiple <image> sentinels per row (llava_arch.py's while-loop over
    image_token_indices, :291-389): sentinel k is expanded with image k's
    visual block, left to right. vis_tokens: [R, max_images, V, H]; rows with
    fewer sentinels get masked-off blocks appended (uniform lengths)."""
    r, t = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((r, t), dtype=torch.bool, device=input_ids.device)
    embeds = llm.embed(params["llm"], input_ids.clamp_min(0))
    sentinels = input_ids == IMAGE_TOKEN_INDEX
    attn, lab, first_pos = attention_mask, labels, None
    for k in range(vis_tokens.shape[1]):
        embeds, sentinels, attn, lab, pos = _splice_block(embeds, sentinels, attn, lab,
                                                          vis_tokens[:, k])
        if first_pos is None:
            first_pos = pos
    return Spliced(embeds=embeds, attention_mask=attn, image_pos=first_pos, labels=lab)


def seg_timeline_mask(input_ids: torch.Tensor, seg_token_id, cfg: WalkGPTConfig
                      ) -> torch.Tensor:
    """The [SEG] mask on the spliced timeline: [SEG] over input_ids[:, 1:],
    one False appended, V-1 False prepended. Indexing the hidden states with
    it gives, per [SEG], the state at the position before it: the state
    that predicted the [SEG] token."""
    sids = seg_token_id if isinstance(seg_token_id, (list, tuple)) else (seg_token_id,)
    r = input_ids.shape[0]
    m = torch.zeros_like(input_ids[:, 1:], dtype=torch.bool)
    for sid in sids:
        m = m | (input_ids[:, 1:] == sid)
    dev = input_ids.device
    return torch.cat([torch.zeros((r, cfg.visual_tokens - 1), dtype=torch.bool, device=dev), m,
                      torch.zeros((r, 1), dtype=torch.bool, device=dev)], dim=1)


def _seg_ids(cfg: WalkGPTConfig) -> tuple:
    """The [SEG] token ids (cfg.seg_token_id is one id or a list of them)."""
    sid = cfg.seg_token_id
    return tuple(sid) if isinstance(sid, (list, tuple)) else (sid,)


def _first_true(flat: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices of the first `size` True entries of the bool vector `flat`,
    padded with 0; valid [size]), as jnp.nonzero(size=, fill_value=0) gives
    them, without asking the host how many there are: each True entry's
    rank is its running count, and the first `size` ranks are scattered to
    their slots (the rest into a spare slot that is dropped)."""
    rank = flat.long().cumsum(0) - 1
    slot = torch.where(flat & (rank < size), rank, size)
    idx = torch.zeros(size + 1, dtype=torch.long, device=flat.device)
    idx.scatter_(0, slot, torch.arange(flat.numel(), device=flat.device))
    return idx[:size], torch.arange(size, device=flat.device) < flat.sum()


# ---------------------------------------------------------------------------
# training / teacher-forced forward
# ---------------------------------------------------------------------------

class ForwardOutput(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    mask_bce_loss: torch.Tensor
    mask_dice_loss: torch.Tensor
    nce_loss: torch.Tensor
    mask_loss: torch.Tensor
    pred_masks: torch.Tensor      # [max_segs, S, S] logits on the img_size canvas
    seg_valid: torch.Tensor       # [max_segs]
    seg_rows: torch.Tensor        # [max_segs] conversation row of each [SEG]
    mask_scores: torch.Tensor     # [max_segs]


def model_forward(params, cfg: WalkGPTConfig, *, images: torch.Tensor,
                  input_ids: torch.Tensor, labels: torch.Tensor,
                  attention_mask: torch.Tensor, row_image_idx: torch.Tensor,
                  gt_masks: torch.Tensor, pixel_hw: torch.Tensor, max_segs: int,
                  remat: bool = False) -> ForwardOutput:
    """The teacher-forced forward and the losses, with static shapes.

    images [B, S, S, 3]; input_ids, labels [R, T] (with the <image>
    sentinel; labels IGNORE_INDEX where not trained); attention_mask [R, T]
    bool; row_image_idx [R]; gt_masks [max_segs, S, S] on the canvas;
    pixel_hw [B, 2] valid (h, w) per image; all on the parameters' device.
    With cfg.use_flash_attention the LLM runs K1 (backward K1b) and the SAM
    encoder K2/K3. The encoder runs without gradients unless one of its
    leaves requires them: the JAX step differentiates it and then drops
    those gradients (optax set_to_zero never reads them), so its compiled
    step computes no more than this. remat recomputes each LLM block in the
    backward pass."""
    flash_fn = _flash_fn(cfg)
    lw = cfg.losses

    # 1. SAM encode once per image, expanded per conversation row
    encoder_grads = any(isinstance(x, torch.Tensor) and x.requires_grad
                        for x in leaves_with_path(params["sam"]["image_encoder"]).values())
    with contextlib.nullcontext() if encoder_grads else torch.no_grad():
        feats, sam_tokens = encode_sam(params, cfg, images)
    vis_rows = visual_tokens(params, cfg, sam_tokens)[row_image_idx]

    # 2. splice + LLM forward
    sp = splice_visual(params, cfg, input_ids, vis_rows, attention_mask=attention_mask,
                       labels=labels)
    hidden, _ = llm.forward(params["llm"], cfg.llm, sp.embeds,
                            attention_mask=sp.attention_mask, flash_fn=flash_fn, remat=remat)
    logits = llm.lm_logits(params["llm"], cfg.llm, hidden)

    # 3. token CE on the shifted, label-smoothed targets
    ce = cross_entropy_with_smoothing(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                      sp.labels[:, 1:].reshape(-1), ignore_index=IGNORE_INDEX,
                                      label_smoothing=lw.label_smoothing)

    # 4. [SEG] gather on the spliced timeline
    seg_mask = seg_timeline_mask(input_ids, cfg.seg_token_id, cfg)
    seg_idx, seg_valid = _first_true(seg_mask.reshape(-1), max_segs)
    seg_rows = seg_idx // seg_mask.shape[1]
    head = seg_losses(params, cfg, hidden.reshape(-1, hidden.shape[-1])[seg_idx], seg_valid,
                      seg_rows, feats=feats, sam_tokens=sam_tokens, input_ids=input_ids,
                      labels=labels, row_image_idx=row_image_idx, gt_masks=gt_masks,
                      pixel_hw=pixel_hw)

    ce_loss, bce_loss = lw.ce * ce, lw.bce * head.bce
    dice_loss, nce_loss = lw.dice * head.dice, lw.nce * head.nce
    mask_loss = bce_loss + dice_loss
    return ForwardOutput(loss=ce_loss + mask_loss + nce_loss, ce_loss=ce_loss,
                         mask_bce_loss=bce_loss, mask_dice_loss=dice_loss, nce_loss=nce_loss,
                         mask_loss=mask_loss, pred_masks=head.pred_canvas, seg_valid=seg_valid,
                         seg_rows=seg_rows,
                         mask_scores=_mask_score(head.pred_canvas.detach(), head.pixel_valid))


class SegLosses(NamedTuple):
    bce: torch.Tensor             # unweighted mask BCE
    dice: torch.Tensor            # unweighted mask dice
    nce: torch.Tensor             # unweighted InfoNCE
    pred_canvas: torch.Tensor     # [max_segs, S, S] logits on the img_size canvas
    pixel_valid: torch.Tensor     # [max_segs, S, S] bool: the [SEG]'s image's valid region


def seg_losses(params, cfg: WalkGPTConfig, seg_hidden: torch.Tensor, seg_valid: torch.Tensor,
               seg_rows: torch.Tensor, *, feats: torch.Tensor, sam_tokens: torch.Tensor,
               input_ids: torch.Tensor, labels: torch.Tensor, row_image_idx: torch.Tensor,
               gt_masks: torch.Tensor, pixel_hw: torch.Tensor) -> SegLosses:
    """model_forward's [SEG] head on the gathered [SEG] states: CTP,
    InfoNCE against every row's SAM tokens, the mask decode against each
    [SEG]'s image and the mask losses over num_masks = seg_valid.sum().
    seg_hidden [max_segs, H] (the states that predicted each [SEG], in
    row-major order), seg_valid and seg_rows [max_segs]; feats and
    sam_tokens of all B images; input_ids, labels and row_image_idx of all
    R rows. The sharded training step runs it on every rank on the [SEG]
    states gathered over dp."""
    lw = cfg.losses
    r = input_ids.shape[0]
    pred_embeddings = ctp_apply(params["ctp"][0], seg_hidden)

    # 5. InfoNCE region alignment; rows with no image sentinel, no [SEG] and
    #    no trained label are padding rows and leave the negative pool
    row_nce_ok = (input_ids == IMAGE_TOKEN_INDEX).any(dim=1) | (labels != IGNORE_INDEX).any(dim=1)
    for sid in _seg_ids(cfg):
        row_nce_ok = row_nce_ok | (input_ids == sid).any(dim=1)
    nce = infonce_loss(pred_embeddings, sam_tokens[row_image_idx], seg_rows,
                       params["tiny_xattn"], temperature=lw.nce_tau, top_k=lw.nce_topk,
                       exclude_same_row=r > 1, valid=seg_valid, row_valid=row_nce_ok)

    # 6. SAM mask decoding per [SEG] against its own image's features
    img_of_seg = row_image_idx[seg_rows]
    low_res, _ = sam.decode_masks(params["sam"], sam_config(cfg), feats[img_of_seg],
                                  text_embeds=pred_embeddings[:, None], multimask_output=False)
    img_size = cfg.sam.img_size
    pred_canvas = bilinear_resize(low_res[:, 0][..., None], (img_size, img_size))[..., 0]

    # 7. mask losses on the canvas, restricted to each image's valid region
    hw = pixel_hw[img_of_seg]
    dev = pred_canvas.device
    yy = torch.arange(img_size, device=dev)[None, :, None]
    xx = torch.arange(img_size, device=dev)[None, None, :]
    pixel_valid = (yy < hw[:, 0, None, None]) & (xx < hw[:, 1, None, None])
    num_masks = seg_valid.sum().float()
    bce = _masked_bce(pred_canvas, gt_masks, pixel_valid, seg_valid, num_masks)
    dice = _masked_dice(pred_canvas, gt_masks, pixel_valid, seg_valid, num_masks,
                        scale=lw.dice_scale)
    return SegLosses(bce=bce, dice=dice, nce=nce, pred_canvas=pred_canvas,
                     pixel_valid=pixel_valid)


def _masked_bce(pred, gt, pixel_valid, seg_valid, num_masks):
    """Per-mask BCE with logits averaged over the valid pixels, summed over
    the valid masks, over (num_masks + 1e-8)."""
    x, tgt, pv = pred.float(), gt.float(), pixel_valid.float()
    per_elem = x.clamp_min(0) - x * tgt + torch.log1p(torch.exp(-x.abs()))
    per_mask = (per_elem * pv).flatten(1).sum(-1) / pv.flatten(1).sum(-1).clamp_min(1.0)
    return (per_mask * seg_valid.float()).sum() / (num_masks + 1e-8)


def _masked_dice(pred, gt, pixel_valid, seg_valid, num_masks, *, scale=1000.0, eps=1e-6):
    """Scale-stabilised dice over the valid pixels, per valid mask, over
    (num_masks + 1e-8)."""
    pv = pixel_valid.float()
    p = (torch.sigmoid(pred.float()) * pv).flatten(1)
    tgt = (gt.float() * pv).flatten(1)
    numerator = 2.0 * (p / scale * tgt).sum(-1)
    denominator = (p / scale).sum(-1) + (tgt / scale).sum(-1)
    loss = (1.0 - (numerator + eps) / (denominator + eps)) * seg_valid.float()
    return loss.sum() / (num_masks + 1e-8)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

class EvaluateOutput(NamedTuple):
    tokens: torch.Tensor          # [R, max_new]
    lengths: torch.Tensor         # [R]
    pred_masks: torch.Tensor      # [max_segs, S, S] canvas logits
    seg_valid: torch.Tensor       # [max_segs]
    seg_rows: torch.Tensor        # [max_segs]
    mask_scores: torch.Tensor     # [max_segs]
    n_iters: Optional[int] = None  # speculative verify iterations (speculative_k > 0)


def _mask_score(pred_canvas, pixel_valid):
    """Mean sigmoid over the predicted-positive valid region."""
    pos = (pred_canvas > 0) & pixel_valid
    s = torch.sigmoid(pred_canvas.float()) * pos
    return s.flatten(1).sum(-1) / (pos.flatten(1).sum(-1) + 1e-6)


def decode_seg_masks(params, cfg: WalkGPTConfig, feats: torch.Tensor,
                     pred_embeddings: torch.Tensor, img_of_seg: torch.Tensor,
                     pixel_hw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per [SEG] embedding: SAM mask decode against its image's features,
    bilinear upsample to the img_size canvas, and the mask score over the
    image's valid pixels. Runs in cfg.mask_decode_chunk slices.
    Returns (canvas logits [M, S, S], scores [M])."""
    img_size = cfg.sam.img_size
    m = pred_embeddings.shape[0]
    dev = pred_embeddings.device
    yy = torch.arange(img_size, device=dev)[None, :, None]
    xx = torch.arange(img_size, device=dev)[None, None, :]

    def seg_chunk(emb, img_idx):
        low_res, _ = sam.decode_masks(params["sam"], sam_config(cfg), feats[img_idx],
                                      text_embeds=emb[:, None], multimask_output=False)
        canvas = bilinear_resize(low_res[:, 0][..., None], (img_size, img_size))[..., 0]
        hw = pixel_hw[img_idx]
        pixel_valid = (yy < hw[:, 0, None, None]) & (xx < hw[:, 1, None, None])
        return canvas, _mask_score(canvas, pixel_valid)

    chunk = cfg.mask_decode_chunk
    if chunk and m > chunk and m % chunk == 0:
        parts = [seg_chunk(pred_embeddings[i:i + chunk], img_of_seg[i:i + chunk])
                 for i in range(0, m, chunk)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    return seg_chunk(pred_embeddings, img_of_seg)


def _seg_gather(params, cfg: WalkGPTConfig, tokens: torch.Tensor,
                pred_hidden: torch.Tensor, max_segs: int):
    """[SEG] positions over the generated tokens -> (seg_valid [max_segs],
    seg_rows [max_segs], CTP embeddings [max_segs, C]). Always max_segs
    entries: the first max_segs [SEG] positions in row-major order, padded
    with index 0; seg_valid marks the real ones."""
    seg_mask = torch.zeros_like(tokens, dtype=torch.bool)
    for sid in _seg_ids(cfg):
        seg_mask = seg_mask | (tokens == sid)
    seg_idx, seg_valid = _first_true(seg_mask.reshape(-1), max_segs)
    seg_rows = seg_idx // tokens.shape[1]
    hid = pred_hidden.reshape(-1, pred_hidden.shape[-1])[seg_idx]
    return seg_valid, seg_rows, ctp_apply(params["ctp"][0], hid)


class SegEmbeds(NamedTuple):
    tokens: torch.Tensor          # [R, max_new]
    lengths: torch.Tensor         # [R]
    seg_valid: torch.Tensor       # [max_segs]
    seg_rows: torch.Tensor        # [max_segs]
    pred_embeddings: torch.Tensor  # [max_segs, C] CTP-projected [SEG] states


def _as_inputs(dev, **arrays):
    """Arrays or tensors -> tensors on dev (ids long, masks bool)."""
    out = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    for k in ("input_ids", "row_image_idx", "labels"):
        if k in out:
            out[k] = out[k].long()
    if "attention_mask" in out:
        out["attention_mask"] = out["attention_mask"].bool()
    return out


def _flash_fn(cfg: WalkGPTConfig):
    """K1 as the LLM's causal attention where cfg.use_flash_attention."""
    if not cfg.use_flash_attention:
        return None
    return lambda q, k, v, kv: flash_attention(q, k, v, True, key_valid=kv)


def _generate(params, cfg: WalkGPTConfig, vis_rows, input_ids, attention_mask,
              max_new_tokens: int, eos_id: int, speculative_k: int,
              fused_layer: Optional[bool] = None, vis_mask_rows=None, tp=None) -> GenerateResult:
    """Visual tokens per row -> splice -> greedy decode (with fused_layer,
    K12 in its steps; with cfg.decode_cache_grow, the growing cache), or
    speculative decode with `speculative_k` drafts per iteration whose
    lookup history is the textual prompt (the <image> sentinel and pad
    positions excluded). tp: the LLM as one rank of a manual tp mesh or of
    the GSPMD leg (runtime/generate.py)."""
    sp = splice_visual(params, cfg, input_ids, vis_rows, attention_mask=attention_mask,
                       vis_mask=vis_mask_rows, tp=tp)
    kw = dict(max_new_tokens=max_new_tokens, eos_id=eos_id, flash_fn=_flash_fn(cfg),
              kv_quant=cfg.kv_quant_cache or "", prefill_chunk=cfg.prefill_chunk, tp=tp)
    if speculative_k > 0:
        hist_ids = torch.where(attention_mask & (input_ids >= 0), input_ids, -2)
        return speculative_generate(params["llm"], cfg.llm, sp.embeds, sp.attention_mask,
                                    draft_k=speculative_k, prompt_ids=hist_ids, **kw)
    return greedy_generate(params["llm"], cfg.llm, sp.embeds, sp.attention_mask,
                           cache_grow_step=cfg.decode_cache_grow, fused_layer=fused_layer,
                           **kw)


@torch.inference_mode()
def generate_and_segment(params, cfg: WalkGPTConfig, *,
                         images, input_ids, attention_mask, row_image_idx, pixel_hw,
                         max_new_tokens: int, max_segs: int, eos_id: int,
                         speculative_k: int = 0, fused_layer: Optional[bool] = None,
                         precomputed_sam=None, images_clip=None, clip_resize_hw=None,
                         visual_stream: str = "sam", device=None) -> EvaluateOutput:
    """The PAVE evaluate pipeline: encode, splice, greedy (or, with
    speculative_k > 0, speculative) decode, [SEG] gather, CTP, mask decode.

    visual_stream selects the generation-time visual tokens:
      "sam"  — SAM-MSQP tokens (the PAVE validate route);
      "clip" — images_clip [B, S_clip, S_clip, 3] (CLIP-448 pixels, fp32 as
               the data path gives them) through the CLIP tower and the
               mm_projector, with clip_resize_hw [B, 2] (each image's valid
               (h, w) on the CLIP canvas), when given, masking the padded
               patches in the tower and on the visual grid.
    Either way the masks decode against the SAM features of `images`.

    images [B, S, S, 3] (its dtype is the activation dtype of the encoder);
    input_ids [R, T] prompts with the <image> sentinel, right-padded;
    attention_mask [R, T] bool; row_image_idx [R]; pixel_hw [B, 2] valid
    (h, w) per image. Arrays or tensors; they are moved to `device`
    (default CUDA). With cfg.use_flash_attention the LLM prefill runs K1 and
    the SAM encoder K2/K3; a flat quantized cache runs K4 in every decode
    step and K8 in every speculative chunk, the flat bf16 cache of
    cfg.llm.fused_decode K11, and quantized weights K5-K7 (ops/int4.py).
    fused_layer (default ops/fused_layer.FUSED_LAYER, the JAX package's
    WALKGPT_FUSED_LAYER): each greedy step
    runs K12 (attention, o-proj, residual, post-norm and MLP in one launch)
    on the layers of the int4x format over a flat quantized cache
    (llm.decode_step); the speculative chunks never fuse, as in the JAX
    package, so with speculative_k > 0 it changes nothing.
    precomputed_sam: (feats, sam_tokens) from encode_sam of these images,
    which the call then does not encode again (images is not read)."""
    dev = resolve_device(device)
    x = _as_inputs(dev, input_ids=input_ids, attention_mask=attention_mask,
                   row_image_idx=row_image_idx, pixel_hw=pixel_hw)
    if precomputed_sam is not None:
        feats, sam_tokens = (torch.as_tensor(t, device=dev) for t in precomputed_sam)
    else:
        feats, sam_tokens = encode_sam(params, cfg, torch.as_tensor(images, device=dev))
    rows, vis_mask_rows = x["row_image_idx"], None
    if visual_stream == "clip":
        if images_clip is None:
            raise ValueError("the clip stream needs images_clip")
        hw = None if clip_resize_hw is None else torch.as_tensor(clip_resize_hw, device=dev)
        clip_toks, llm_mask = clip_visual_tokens(
            params, cfg, torch.as_tensor(images_clip, device=dev), hw)
        vis_rows = clip_toks[rows]
        if llm_mask is not None:
            vis_mask_rows = llm_mask[rows]
    elif visual_stream == "sam":
        vis_rows = visual_tokens(params, cfg, sam_tokens)[rows]
    else:
        raise ValueError(f"visual_stream {visual_stream!r}")
    res = _generate(params, cfg, vis_rows, x["input_ids"], x["attention_mask"],
                    max_new_tokens, eos_id, speculative_k, fused_layer, vis_mask_rows)
    seg_valid, seg_rows, pred_embeddings = _seg_gather(params, cfg, res.tokens,
                                                       res.pred_hidden, max_segs)
    pred_canvas, score = decode_seg_masks(params, cfg, feats, pred_embeddings,
                                          x["row_image_idx"][seg_rows], x["pixel_hw"])
    return EvaluateOutput(tokens=res.tokens, lengths=res.lengths, pred_masks=pred_canvas,
                          seg_valid=seg_valid, seg_rows=seg_rows, mask_scores=score,
                          n_iters=res.n_iters)


@torch.inference_mode()
def generate_seg_embeds(params, cfg: WalkGPTConfig, *, sam_tokens=None, input_ids,
                        attention_mask, row_image_idx=None, max_new_tokens: int, max_segs: int,
                        eos_id: int, speculative_k: int = 0, tp=None, vis_rows=None,
                        vis_mask_rows=None, device=None) -> SegEmbeds:
    """generate_and_segment without the encode and the mask decode: SAM
    tokens [B, L, C] (encode_sam's second output) and row_image_idx, or the
    rows' visual tokens vis_rows [R, V, H] (with vis_mask_rows [R, V], the
    CLIP stream's), -> splice -> greedy or speculative decode -> [SEG]
    gather -> CTP. tp: one rank of a manual tp mesh
    (parallel/tp.make_tp_generate; params["llm"] and cfg.llm are its head
    and intermediate shard, the rest runs replicated) or of the GSPMD leg
    (parallel/infer.make_sharded_generate)."""
    dev = resolve_device(device)
    x = _as_inputs(dev, input_ids=input_ids, attention_mask=attention_mask)
    if vis_rows is None:
        vis_rows = visual_tokens(params, cfg, torch.as_tensor(sam_tokens, device=dev))[
            torch.as_tensor(row_image_idx, device=dev).long()]
    res = _generate(params, cfg, vis_rows, x["input_ids"], x["attention_mask"],
                    max_new_tokens, eos_id, speculative_k, vis_mask_rows=vis_mask_rows, tp=tp)
    seg_valid, seg_rows, emb = _seg_gather(params, cfg, res.tokens, res.pred_hidden, max_segs)
    return SegEmbeds(tokens=res.tokens, lengths=res.lengths, seg_valid=seg_valid,
                     seg_rows=seg_rows, pred_embeddings=emb)


@torch.inference_mode()
def teacher_seg_embeds(params, cfg: WalkGPTConfig, *, sam_tokens, input_ids, attention_mask,
                       row_image_idx, max_segs: int, tp=None, device=None) -> SegEmbeds:
    """The teacher-forced [SEG] embeddings (model_forward without the losses
    and the mask decode): the conversation rows forward once, the [SEG]
    states gathered on the spliced timeline, CTP. tokens are the input ids
    and lengths the rows' valid counts. The sharded eval pass
    (parallel/tp.make_tp_forward) runs it in every rank and decodes the
    masks once; tp as in generate_seg_embeds."""
    dev = resolve_device(device)
    x = _as_inputs(dev, sam_tokens=sam_tokens, input_ids=input_ids,
                   attention_mask=attention_mask, row_image_idx=row_image_idx)
    ids = x["input_ids"]
    vis_rows = visual_tokens(params, cfg, x["sam_tokens"])[x["row_image_idx"]]
    sp = splice_visual(params, cfg, ids, vis_rows, attention_mask=x["attention_mask"], tp=tp)
    hidden, _ = llm.forward(params["llm"], cfg.llm, sp.embeds, attention_mask=sp.attention_mask,
                            flash_fn=_flash_fn(cfg), tp=tp)
    seg_mask = seg_timeline_mask(ids, cfg.seg_token_id, cfg)
    seg_idx, seg_valid = _first_true(seg_mask.reshape(-1), max_segs)
    seg_rows = seg_idx // seg_mask.shape[1]
    emb = ctp_apply(params["ctp"][0], hidden.reshape(-1, hidden.shape[-1])[seg_idx])
    return SegEmbeds(tokens=ids, lengths=x["attention_mask"].long().sum(-1),
                     seg_valid=seg_valid, seg_rows=seg_rows, pred_embeddings=emb)


def finalize_masks(pred_canvas: torch.Tensor, input_hw: Tuple[int, int],
                   original_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop the valid region of the canvas and bilinearly resize it to the
    original image size."""
    x = pred_canvas[:, :input_hw[0], :input_hw[1]][..., None]
    return bilinear_resize(x, tuple(original_hw))[..., 0]


# ---------------------------------------------------------------------------
# the CLIP stream: pixels -> CLIP tower -> mm_projector -> [B, V, H] tokens
# ---------------------------------------------------------------------------

def clip_padding_masks(cfg: WalkGPTConfig, clip_resize_hw: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padding masks for the padded-CLIP pixel path (llava_arch.py:160-193):
    clip_resize_hw [B, 2] valid (h, w) per image ->
      (token mask [B, 1+P] over [class]+patch tokens,
       LLM-side mask [B, visual_tokens] nearest-downsampled to the grid).
    A patch row / column is valid when its nearest source pixel (floor
    indexing) lies inside (h, w)."""
    if cfg.clip is None:
        raise ValueError("the config has no CLIP tower")
    g = cfg.clip.grid
    b = clip_resize_hw.shape[0]
    dev = clip_resize_hw.device
    idx = torch.floor(torch.arange(g, device=dev) * (cfg.clip.image_size / g)).long()
    rows = idx[None, :] < clip_resize_hw[:, 0, None]
    cols = idx[None, :] < clip_resize_hw[:, 1, None]
    patch_valid = rows[:, :, None] & cols[:, None, :]                    # [B, g, g]
    cls = torch.ones((b, 1), dtype=torch.bool, device=dev)
    token_mask = torch.cat([cls, patch_valid.reshape(b, g * g)], dim=1)
    t = cfg.visual_grid
    tr = torch.floor(torch.arange(t, device=dev) * (g / t)).long()
    llm_mask = patch_valid[:, tr[:, None], tr[None, :]].reshape(b, t * t)
    return token_mask, llm_mask


def encode_clip_tokens(params, cfg: WalkGPTConfig, images_clip: torch.Tensor, *,
                       attention_mask: Optional[torch.Tensor] = None,
                       clip_resize_hw: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """CLIP pixel path: tower (with the padding mask from clip_resize_hw when
    no attention_mask is given) -> select_layer patch features ->
    mm_projector, [B, P, H]. The projector is applied, as the JAX package
    applies it (the reference's code has it commented out, and its raw
    tower features could not splice into an H_llm timeline). tp: a rank of
    the GSPMD leg (the tower split over tp, the projector whole)."""
    if cfg.clip is None or "clip" not in params:
        raise ValueError("CLIP tower not built")
    if attention_mask is None and clip_resize_hw is not None:
        attention_mask, _ = clip_padding_masks(cfg, clip_resize_hw)
    hs = clip_vit.apply(params["clip"], cfg.clip, images_clip, attention_mask=attention_mask,
                        tp=tp)
    feats, _aux = clip_vit.select_features(hs, cfg.clip)
    return nn.linear(params["mm_projector"], feats)


def clip_visual_tokens(params, cfg: WalkGPTConfig, images_clip: torch.Tensor,
                       clip_resize_hw: Optional[torch.Tensor] = None, tp=None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """CLIP pixels -> spliceable LLM tokens: encode_clip_tokens, then a
    bilinear downsample of the patch grid to the visual grid
    (llava_arch.py:251-259), plus the LLM-side validity mask
    (vit_attention_mask_for_llm, :176-181). Returns (tokens [B, V, H],
    llm_mask [B, V] bool, or None without clip_resize_hw)."""
    toks = encode_clip_tokens(params, cfg, images_clip, clip_resize_hw=clip_resize_hw, tp=tp)
    b, l, h = toks.shape
    g = int(round(l ** 0.5))
    if g * g != l:
        raise ValueError(f"CLIP token count {l} is not square")
    t = cfg.visual_grid
    grid = bilinear_resize(toks.reshape(b, g, g, h), (t, t))
    llm_mask = None
    if clip_resize_hw is not None:
        _, llm_mask = clip_padding_masks(cfg, clip_resize_hw)
    return grid.reshape(b, t * t, h), llm_mask
