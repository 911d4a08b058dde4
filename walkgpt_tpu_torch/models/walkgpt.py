"""WalkGPT grounded-navigation inference (PyTorch counterpart of
walkgpt_tpu/models/walkgpt.py, SAM visual stream).

    SAM ViT encode ─┬─> MSQP -> 6x6 tokens -> bilinear 16x16 -> splice at <image>
                    │      -> LLaMA prefill (K1) + greedy decode
                    │      -> [SEG] predictor hidden states -> CTP
                    └──────────────────────────> SAM prompt encoder + mask decoder

The entry points (`init`, `init_quantized`, `generate_and_segment`) run on
CUDA unless the caller passes another device. Besides dense weights, the
quantized production formats run: W8A8 or packed-int4 LLM weights
(`init_quantized`), int8 SAM encoder blocks, and the flat int8 / packed
int4 KV caches (cfg.kv_quant_cache "int8_flat" / "int4_flat"). The CLIP
visual stream, speculative decode, the teacher-forced forward and the
training losses are not ported yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.config import WalkGPTConfig
from ..core.tree import resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.quant import quantize_sam_encoder, quantized_llm_init
from ..ops.resize import bilinear_resize
from ..runtime.generate import greedy_generate
from . import llm, sam
from .projectors import ctp_apply, ctp_init, msqp_apply, msqp_init, tiny_xattn_init

IMAGE_TOKEN_INDEX = -200


def sam_config(cfg: WalkGPTConfig) -> sam.SamConfig:
    return sam.SamConfig(encoder=cfg.sam, prompt=cfg.prompt_encoder,
                         decoder=cfg.mask_decoder)


def init(cfg: WalkGPTConfig, *, seed: int = 0, dtype=torch.float32, device=None,
         llm_init=None) -> Dict:
    """Random parameters with the JAX package's tree layout (without the CLIP
    tower and its projector, whose stream is not ported yet), built leaf by
    leaf on `device` (default CUDA) from a seeded torch.Generator.
    llm_init(g, cfg.llm, dtype), when given, builds the LLM subtree."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return {
        "llm": (llm_init or llm.init)(g, cfg.llm, dtype),
        "sam": sam.init(g, sam_config(cfg), dtype),
        "msqp": msqp_init(g, cfg.msqp, cfg.llm.hidden_size, dtype),
        "ctp": [ctp_init(g, cfg.ctp, cfg.llm.hidden_size, dtype)],
        "tiny_xattn": tiny_xattn_init(g, cfg.msqp.sam_dim, dtype),
    }


def init_quantized(cfg: WalkGPTConfig, *, seed: int = 0, dtype=torch.bfloat16,
                   device=None, act_quant: bool = False, sam_int8: bool = False,
                   mlp_int4: bool = False, attn_int4: bool = False,
                   head_int4: bool = False) -> Dict:
    """`init`'s layout with a quantized LLM built one layer at a time on the
    device (ops/quant.quantized_llm_init): act_quant marks the int8
    projections W8A8, mlp_int4 / attn_int4 / head_int4 pack the MLPs, the
    fused q/k/v and the lm_head as int4. sam_int8 quantizes the SAM encoder
    blocks' projections (W8A8 with act_quant).

    WalkGPT-7B's production format: act_quant, mlp_int4, attn_int4,
    head_int4 and sam_int8 (with kv_quant_cache "int4_flat"); WalkGPT-1B's:
    act_quant and sam_int8 (with "int8_flat")."""
    def llm_init(g, llm_cfg, dt):
        return quantized_llm_init(g, llm_cfg, dt, act_quant=act_quant, mlp_int4=mlp_int4,
                                  attn_int4=attn_int4, head_int4=head_int4)
    params = init(cfg, seed=seed, dtype=dtype, device=device, llm_init=llm_init)
    if sam_int8:
        params["sam"] = quantize_sam_encoder(params["sam"], act_quant=act_quant)
    return params


# ---------------------------------------------------------------------------
# vision encoding
# ---------------------------------------------------------------------------

def encode_sam(params, cfg: WalkGPTConfig, images: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, S, S, 3] -> (feature maps [B, g, g, C], tokens [B, g*g, C]).
    sam_encode_chunk > 0 encodes sub-batches one after the other."""
    if cfg.fast_windowed_attention and not cfg.use_flash_attention:
        raise NotImplementedError("fast_windowed_attention on the einsum attention "
                                  "is not ported yet")

    def enc(im):
        return sam.encode_image(params["sam"], sam_config(cfg), im,
                                use_flash=cfg.use_flash_attention, fast_gelu=cfg.fast_gelu)
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


def splice_visual(params, cfg: WalkGPTConfig, input_ids: torch.Tensor,
                  vis_tokens: torch.Tensor,
                  attention_mask: Optional[torch.Tensor] = None) -> Spliced:
    """Replace each row's <image> sentinel by the V visual tokens (+V-1 net
    growth). Rows without a sentinel get the block appended at their first
    pad slot with attention masked off (text-only rows)."""
    r, t = input_ids.shape
    v = cfg.visual_tokens
    out_len = t - 1 + v
    dev = input_ids.device
    if attention_mask is None:
        attention_mask = torch.ones((r, t), dtype=torch.bool, device=dev)
    is_img = input_ids == IMAGE_TOKEN_INDEX
    has_img = is_img.any(dim=1)
    pos = torch.where(has_img, is_img.int().argmax(dim=1),
                      attention_mask.long().sum(-1).clamp_max(t - 1))       # [R]
    tok_embeds = llm.embed(params["llm"], input_ids.clamp_min(0))           # [R, T, H]

    j = torch.arange(out_len, device=dev)[None]
    p = pos[:, None]
    before = j < p
    inside = (j >= p) & (j < p + v)
    tok_idx = torch.where(before, j, j - (v - 1)).clamp(0, t - 1)
    vis_idx = (j - p).clamp(0, v - 1)
    hd = tok_embeds.shape[-1]
    g_tok = torch.gather(tok_embeds, 1, tok_idx[..., None].expand(r, out_len, hd))
    g_vis = torch.gather(vis_tokens.to(g_tok.dtype), 1,
                         vis_idx[..., None].expand(r, out_len, hd))
    embeds = torch.where(inside[..., None], g_vis, g_tok)
    attn_tok = torch.gather(attention_mask, 1, tok_idx)
    attn = torch.where(inside, has_img[:, None], attn_tok)
    return Spliced(embeds=embeds, attention_mask=attn, image_pos=pos)


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
    sids = cfg.seg_token_id if isinstance(cfg.seg_token_id, (list, tuple)) \
        else (cfg.seg_token_id,)
    seg_mask = torch.zeros_like(tokens, dtype=torch.bool)
    for sid in sids:
        seg_mask = seg_mask | (tokens == sid)
    flat = seg_mask.reshape(-1)
    found = torch.nonzero(flat)[:max_segs, 0]
    seg_idx = torch.zeros(max_segs, dtype=torch.long, device=tokens.device)
    seg_idx[:found.numel()] = found
    seg_valid = torch.arange(max_segs, device=tokens.device) < flat.sum()
    seg_rows = seg_idx // tokens.shape[1]
    hid = pred_hidden.reshape(-1, pred_hidden.shape[-1])[seg_idx]
    return seg_valid, seg_rows, ctp_apply(params["ctp"][0], hid)


@torch.inference_mode()
def generate_and_segment(params, cfg: WalkGPTConfig, *,
                         images, input_ids, attention_mask, row_image_idx, pixel_hw,
                         max_new_tokens: int, max_segs: int, eos_id: int,
                         device=None) -> EvaluateOutput:
    """The PAVE evaluate pipeline on the SAM visual stream: encode, splice,
    greedy decode, [SEG] gather, CTP, mask decode.

    images [B, S, S, 3] (its dtype is the activation dtype of the encoder);
    input_ids [R, T] prompts with the <image> sentinel, right-padded;
    attention_mask [R, T] bool; row_image_idx [R]; pixel_hw [B, 2] valid
    (h, w) per image. Arrays or tensors; they are moved to `device`
    (default CUDA). With cfg.use_flash_attention the LLM prefill runs K1 and
    the SAM encoder K2/K3; a flat quantized cache runs K4 in every decode
    step, and quantized weights K5-K7 (ops/int4.py)."""
    dev = resolve_device(device)
    images = torch.as_tensor(images, device=dev)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    attention_mask = torch.as_tensor(attention_mask, device=dev).bool()
    row_image_idx = torch.as_tensor(row_image_idx, device=dev).long()
    pixel_hw = torch.as_tensor(pixel_hw, device=dev)
    if cfg.kv_quant_cache not in (False, "", "int8_flat", "int4_flat"):
        raise NotImplementedError(f"kv_quant_cache={cfg.kv_quant_cache!r}: only the flat "
                                  "quantized caches are ported")
    if cfg.decode_cache_grow or cfg.llm.fused_decode:
        raise NotImplementedError("the growing and the flat bf16 KV caches are not "
                                  "ported yet")
    flash_fn = None
    if cfg.use_flash_attention:
        flash_fn = lambda q, k, v, kv: flash_attention(q, k, v, True, key_valid=kv)

    feats, sam_tokens = encode_sam(params, cfg, images)
    vis_rows = visual_tokens(params, cfg, sam_tokens)[row_image_idx]
    sp = splice_visual(params, cfg, input_ids, vis_rows, attention_mask=attention_mask)
    res = greedy_generate(params["llm"], cfg.llm, sp.embeds, sp.attention_mask,
                          max_new_tokens=max_new_tokens, eos_id=eos_id, flash_fn=flash_fn,
                          kv_quant=cfg.kv_quant_cache or "", prefill_chunk=cfg.prefill_chunk)
    seg_valid, seg_rows, pred_embeddings = _seg_gather(params, cfg, res.tokens,
                                                       res.pred_hidden, max_segs)
    pred_canvas, score = decode_seg_masks(params, cfg, feats, pred_embeddings,
                                          row_image_idx[seg_rows], pixel_hw)
    return EvaluateOutput(tokens=res.tokens, lengths=res.lengths, pred_masks=pred_canvas,
                          seg_valid=seg_valid, seg_rows=seg_rows, mask_scores=score)


def finalize_masks(pred_canvas: torch.Tensor, input_hw: Tuple[int, int],
                   original_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop the valid region of the canvas and bilinearly resize it to the
    original image size."""
    x = pred_canvas[:, :input_hw[0], :input_hw[1]][..., None]
    return bilinear_resize(x, tuple(original_hw))[..., 0]
