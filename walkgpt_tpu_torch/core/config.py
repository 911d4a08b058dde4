"""Configuration dataclasses for the PyTorch port of WalkGPT.

A copy of `walkgpt_tpu/core/config.py`: the same dataclasses, fields,
defaults and factories, so that one configuration drives both packages and
the tests can compare them field by field. The port keeps its own copy and
never imports the JAX package.

Fields that select a JAX/TPU-only code path (quantized caches, the fused
flat-cache decode, scan segmentation, growing caches) are kept so the two
configurations stay identical; the port raises where a value it has not
ported yet is requested.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# vision towers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SAMEncoderConfig:
    """SAM ViT image encoder (upstream segment_anything image_encoder.py)."""
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280          # ViT-H
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    use_rel_pos: bool = True

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size  # 64 for 1024/16


SAM_VIT_H = SAMEncoderConfig()
SAM_VIT_L = SAMEncoderConfig(embed_dim=1024, depth=24, num_heads=16,
                             global_attn_indexes=(5, 11, 17, 23))
SAM_VIT_B = SAMEncoderConfig(embed_dim=768, depth=12, num_heads=12,
                             global_attn_indexes=(2, 5, 8, 11))
# Small config for tests / CI.
SAM_VIT_TINY = SAMEncoderConfig(img_size=64, patch_size=16, embed_dim=32, depth=2,
                                num_heads=2, out_chans=32, window_size=2,
                                global_attn_indexes=(1,))


@dataclasses.dataclass(frozen=True)
class PromptEncoderConfig:
    """SAM prompt encoder, with WalkGPT's text_embeds prompt."""
    embed_dim: int = 256
    image_embedding_size: Tuple[int, int] = (64, 64)
    input_image_size: Tuple[int, int] = (1024, 1024)
    mask_in_chans: int = 16


@dataclasses.dataclass(frozen=True)
class MaskDecoderConfig:
    """SAM mask decoder with its two-way transformer."""
    transformer_dim: int = 256
    transformer_depth: int = 2
    transformer_mlp_dim: int = 2048
    transformer_num_heads: int = 8
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-L/14 vision tower, position embeddings bilinearly resized to
    image_size=448."""
    image_size: int = 448
    native_image_size: int = 224   # pretrain size the pos-emb was trained at
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    select_layer: int = -2         # hidden_states[select_layer][:, 1:]
    aux_layer: int = -11
    ln_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size  # 32 for 448/14


CLIP_VIT_L_448 = CLIPVisionConfig()
CLIP_VIT_TINY = CLIPVisionConfig(image_size=28, native_image_size=28, patch_size=14,
                                 hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
                                 select_layer=-2, aux_layer=-1)


# ---------------------------------------------------------------------------
# LLM decoder (LLaMA: RoPE+RMSNorm+SiLU; MPT: ALiBi+LN+GELU;
# StableLM-Epoch: partial RoPE + LN + SiLU + GQA)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32                 # < num_heads => GQA (StableLM repeat_kv)
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rope_pct: float = 1.0                  # StableLM rotates only a fraction of head_dim
    pos_emb: str = "rope"                  # "rope" | "alibi" (MPT)
    norm: str = "rmsnorm"                  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    act: str = "silu"                      # "silu" | "gelu"
    qkv_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    family: str = "llama"                  # "llama" | "mpt" | "stablelm"
    # flat bf16 [B, L, Hkv*D] KV cache with a fused decode-attention kernel
    # (K11) in the JAX package; not ported yet (the quantized flat caches
    # are: WalkGPTConfig.kv_quant_cache).
    fused_decode: bool = False
    # explicit head_dim override. None = hidden_size // num_heads (set by the
    # JAX package's manual tensor parallelism for local head counts).
    head_dim_value: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_value is not None:
            return self.head_dim_value
        return self.hidden_size // self.num_heads


LLAMA_7B = LLMConfig()
LLAMA_13B = LLMConfig(hidden_size=5120, intermediate_size=13824,
                      num_layers=40, num_heads=40, num_kv_heads=40)
LLAMA_1B = LLMConfig(hidden_size=2048, intermediate_size=5504,
                     num_layers=16, num_heads=16, num_kv_heads=16)
LLAMA_TINY = LLMConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                       num_layers=2, num_heads=4, num_kv_heads=4,
                       max_position_embeddings=512)
MPT_7B = LLMConfig(hidden_size=4096, intermediate_size=16384, num_layers=32,
                   num_heads=32, num_kv_heads=32, pos_emb="alibi",
                   norm="layernorm", norm_eps=1e-5, act="gelu",
                   vocab_size=50432, tie_embeddings=True, family="mpt")
STABLELM_3B = LLMConfig(hidden_size=2560, intermediate_size=6912, num_layers=32,
                        num_heads=32, num_kv_heads=32, rope_pct=0.25,
                        norm="layernorm", norm_eps=1e-5, vocab_size=50304,
                        family="stablelm")


# ---------------------------------------------------------------------------
# WalkGPT task modules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MSQPConfig:
    """Multi-Scale QFormer Projector."""
    sam_dim: int = 256
    d_proj: int = 1024
    num_heads: int = 8
    num_layers: int = 2
    mlp_ratio: float = 4.0
    queries_x1: int = 12
    queries_x2: int = 8
    queries_x4: int = 8
    queries_global: int = 4
    target_square_side: int = 6            # pads 32 queries -> 36 (6x6) tokens
    gate_hidden: int = 128

    @property
    def num_queries(self) -> int:
        return self.queries_x1 + self.queries_x2 + self.queries_x4 + self.queries_global

    @property
    def num_tokens(self) -> int:
        return self.target_square_side ** 2


@dataclasses.dataclass(frozen=True)
class CTPConfig:
    """Calibrated Text Projector."""
    out_dim: int = 256
    widen: int = 2


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Effective loss weighting of the upstream training recipe."""
    ce: float = 0.1
    dice: float = 0.05
    bce: float = 0.35
    nce: float = 0.2
    label_smoothing: float = 0.1
    nce_tau: float = 0.07
    nce_topk: int = 8
    dice_scale: float = 1000.0


@dataclasses.dataclass(frozen=True)
class WalkGPTConfig:
    llm: LLMConfig = LLAMA_7B
    sam: SAMEncoderConfig = SAM_VIT_H
    prompt_encoder: PromptEncoderConfig = PromptEncoderConfig()
    mask_decoder: MaskDecoderConfig = MaskDecoderConfig()
    clip: Optional[CLIPVisionConfig] = CLIP_VIT_L_448
    msqp: MSQPConfig = MSQPConfig()
    ctp: CTPConfig = CTPConfig()
    losses: LossWeights = LossWeights()
    # token bookkeeping
    visual_tokens: int = 256               # 16x16 grid spliced into the LLM sequence
    visual_grid: int = 16
    seg_token_id: int = -1                 # set after tokenizer build
    image_token_id: int = -200             # sentinel in raw input_ids
    ignore_index: int = -100
    seg_token_num: int = 1
    image_feature_scale_num: int = 1
    max_seq_len: int = 2048
    # True: the attention kernels (LLM prefill, SAM window and global
    # attention); False: the plain einsum attention.
    use_flash_attention: bool = True
    # bf16 bias/logits in the einsum SAM window attention (not ported yet).
    # With use_flash_attention the kernels run and this selects nothing, as
    # in the JAX package.
    fast_windowed_attention: bool = False
    # tanh-approximate GELU in the SAM encoder MLPs.
    fast_gelu: bool = False
    # quantized KV cache: False = full precision; "int8_flat" (int8 rows)
    # and "int4_flat" (packed int4 rows) are the flat quantized caches read
    # by the decode-attention kernel K4. The heads-layout "int8"/True and
    # "int4" of the JAX package are not ported yet.
    kv_quant_cache: "bool | str" = False
    # SAM encoder sub-batch size for encode (0 = whole batch at once).
    sam_encode_chunk: int = 0
    # LLM prefill sub-batch size (0 = whole batch).
    prefill_chunk: int = 0
    # [SEG] mask-decode chunk (0 = all segs at once).
    mask_decode_chunk: int = 64
    # JAX decode-scan segmentation; the port decodes in a Python loop and
    # ignores it (tokens are identical by construction).
    decode_scan_segment: int = 256
    # JAX growing-cache decode segments (not ported; must stay 0).
    decode_cache_grow: int = 0

    def replace(self, **kw) -> "WalkGPTConfig":
        return dataclasses.replace(self, **kw)


def demo_config(seg_token_id: int = 32000) -> WalkGPTConfig:
    """Mid-size full-pipeline config: every subsystem real, small enough to
    run in seconds."""
    sam_demo = SAMEncoderConfig(img_size=256, patch_size=16, embed_dim=256,
                                depth=4, num_heads=8, out_chans=256,
                                window_size=8, global_attn_indexes=(1, 3))
    return WalkGPTConfig(
        llm=LLMConfig(vocab_size=32016, hidden_size=512, intermediate_size=1376,
                      num_layers=4, num_heads=8, num_kv_heads=8,
                      max_position_embeddings=2048),
        sam=sam_demo,
        prompt_encoder=PromptEncoderConfig(image_embedding_size=(16, 16),
                                           input_image_size=(256, 256)),
        mask_decoder=MaskDecoderConfig(),
        clip=CLIP_VIT_TINY,
        msqp=MSQPConfig(d_proj=256),
        ctp=CTPConfig(),
        seg_token_id=seg_token_id,
        max_seq_len=1024,
        use_flash_attention=False,
    )


def flagship_1b_config(seg_token_id: int = 32000) -> WalkGPTConfig:
    """WalkGPT-1B: full SAM ViT-H @1024 + a 1B-class LLaMA decoder."""
    return WalkGPTConfig(
        llm=dataclasses.replace(LLAMA_1B, vocab_size=32016),
        sam=SAM_VIT_H,
        seg_token_id=seg_token_id,
    )


def walkgpt_7b_config(seg_token_id: int = 32008) -> WalkGPTConfig:
    """WalkGPT-7B: SAM ViT-H @1024 + LLaMA-7B (the reference parity scale)."""
    return WalkGPTConfig(llm=dataclasses.replace(LLAMA_7B, vocab_size=32016),
                         seg_token_id=seg_token_id)


def walkgpt_13b_config(seg_token_id: int = 32008) -> WalkGPTConfig:
    """WalkGPT-13B: SAM ViT-H @1024 + LLaMA-13B (the released scale)."""
    return WalkGPTConfig(llm=dataclasses.replace(LLAMA_13B, vocab_size=32016),
                         seg_token_id=seg_token_id)


def tiny_config(seg_token_id: int = 300) -> WalkGPTConfig:
    """A full-pipeline config small enough for CPU tests (all submodules real)."""
    return WalkGPTConfig(
        llm=LLAMA_TINY,
        sam=SAM_VIT_TINY,
        prompt_encoder=PromptEncoderConfig(embed_dim=32,
                                           image_embedding_size=(4, 4),
                                           input_image_size=(64, 64),
                                           mask_in_chans=4),
        mask_decoder=MaskDecoderConfig(transformer_dim=32, transformer_mlp_dim=64,
                                       transformer_num_heads=2),
        clip=CLIP_VIT_TINY,
        msqp=MSQPConfig(sam_dim=32, d_proj=32, num_heads=2, queries_x1=2, queries_x2=1,
                        queries_x4=0, queries_global=1, target_square_side=2,
                        gate_hidden=8),
        ctp=CTPConfig(out_dim=32),
        visual_tokens=16, visual_grid=4,
        seg_token_id=seg_token_id,
        max_seq_len=256,
        use_flash_attention=False,
    )
