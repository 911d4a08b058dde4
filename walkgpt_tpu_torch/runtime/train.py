"""The training step (PyTorch counterpart of the single-device part of
walkgpt_tpu/runtime/train.py).

The reference recipe: AdamW (betas 0.9 / 0.95, no weight decay) with a
linear warmup then linear decay to 0, gradients clipped to a global norm of
1.0, and a trainable set of LoRA(q, v) + lm_head + embed_tokens + the SAM
mask decoder + CTP + MSQP; everything else frozen. The JAX package builds
this from optax; here the same chain is written out in optax's order:

  1. clip_by_global_norm over the trainable leaves only:
     g = where(norm < max, g, g / norm * max);
  2. Adam moments mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu in the
     parameter's dtype, bias-corrected by 1 - b^count (count after its
     increment), u = mu_hat / (sqrt(nu_hat) + eps);
  3. u + weight_decay * p;
  4. u * -schedule(count), count before its increment (so the first update
     has lr 0 while warmup_steps > 0), the rate cast to the parameter's
     dtype;
  5. p + u. Frozen leaves get no gradient, no state and no update: they
     stay the same tensors, bit for bit.

grad_accum > 1 follows optax.MultiSteps: the running mean of the
micro-batch gradients, applied every grad_accum-th call, with no update in
between. QLoRA partitions the tree and differentiates only the trainable
subtree, so the frozen base may be integer-quantized. Not ported here: the
sharded step (make_sharded_train_step) and the training CLI.

Parameters are functional, as in the JAX package: a step returns new
tensors for the trainable leaves and leaves the old state as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Set, Tuple

import torch

from ..core.config import WalkGPTConfig
from ..core.tree import leaves_with_path, map_with_path, resolve_device
from ..models import walkgpt

BATCH_KEYS = ("images", "input_ids", "labels", "attention_mask", "row_image_idx", "gt_masks",
              "pixel_hw")
METRICS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss", "nce_loss", "mask_loss")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 20
    total_steps: int = 270           # 5 epochs x 54 steps
    grad_accum: int = 1
    train_mask_decoder: bool = True
    train_tiny_xattn: bool = False   # the reference leaves TinyCrossAttn frozen
    full_finetune: bool = False      # True trains the whole LLM (no LoRA set)
    tune_projector_only: bool = False  # LLaVA stage-1 adapter pretraining


def warmup_decay_lr(cfg: TrainConfig):
    """DeepSpeed WarmupDecayLR: linear 0 -> lr over warmup_steps, then
    linear lr -> 0 at total_steps; schedule(count) is a 0-d fp32 tensor
    (on the CPU, computed in fp32 as the JAX schedule computes it)."""
    def schedule(step) -> torch.Tensor:
        step = torch.tensor(float(step), dtype=torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        decay = (cfg.total_steps - step) / max(cfg.total_steps - cfg.warmup_steps, 1)
        frac = torch.where(step < cfg.warmup_steps, warm, decay)
        return cfg.lr * frac.clamp(0.0, 1.0)
    return schedule


def _trainable(path: str, cfg: TrainConfig) -> bool:
    if cfg.tune_projector_only:
        return path.startswith(("msqp/", "mm_projector"))
    if cfg.full_finetune and path.startswith("llm/"):
        return True
    if "lora_a" in path or "lora_b" in path:
        return True
    if "lora_scale" in path:
        return False     # peft's alpha / r is a constant, never trained
    if path.startswith(("llm/embed_tokens", "llm/lm_head")):
        return True
    if path.startswith("sam/mask_decoder"):
        return cfg.train_mask_decoder
    if path.startswith(("ctp/", "msqp/", "mm_projector")):
        return True
    if path.startswith("tiny_xattn"):
        return cfg.train_tiny_xattn
    return False


def trainable_mask(params: Any, cfg: TrainConfig) -> Any:
    """Bool tree of params' layout: True = trained (the reference's
    requires_grad policy), keyed by the JAX package's path strings."""
    return map_with_path(lambda path, _: _trainable(path, cfg), params)


def _zip_map(fn, a: Any, b: Any) -> Any:
    """fn over the leaves of two trees of one container structure."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def partition_params(params: Any, mask: Any) -> Tuple[Any, Any]:
    """(trainable, frozen): both keep params' structure, with None at the
    other side's leaves."""
    return (_zip_map(lambda p, m: p if m else None, params, mask),
            _zip_map(lambda p, m: None if m else p, params, mask))


def combine_params(trainable: Any, frozen: Any) -> Any:
    """Inverse of partition_params: at every leaf one side is None."""
    return _zip_map(lambda t, f: f if t is None else t, trainable, frozen)


def _replace(tree: Any, new: Dict[str, Any]) -> Any:
    return map_with_path(lambda path, x: new.get(path, x), tree)


def _cast(x, like: torch.Tensor) -> torch.Tensor:
    """A Python number or a 0-d tensor as a 0-d tensor of like's dtype and
    device: the JAX package's cast of a scalar to the leaf's dtype."""
    return torch.as_tensor(x).to(dtype=like.dtype, device=like.device)


class Optimizer:
    """clip_by_global_norm, then AdamW with a schedule, over the leaves
    whose paths are `trainable` (optax.chain(masked(inner, mask),
    masked(set_to_zero(), not mask)), optionally inside MultiSteps). State:
    {"count": updates applied, "mu", "nu": {path: moment}, and with
    grad_accum > 1 "mini_step", "acc": {path: running mean}}."""

    def __init__(self, cfg: TrainConfig, trainable: Set[str]):
        self.cfg = cfg
        self.trainable = trainable
        self.schedule = warmup_decay_lr(cfg)

    def init(self, params: Any) -> Dict:
        leaves = {p: x for p, x in leaves_with_path(params).items() if p in self.trainable}
        state = {"count": 0, "mu": {p: torch.zeros_like(x) for p, x in leaves.items()},
                 "nu": {p: torch.zeros_like(x) for p, x in leaves.items()}}
        if self.cfg.grad_accum > 1:
            state.update(mini_step=0, acc={p: torch.zeros_like(x) for p, x in leaves.items()})
        return state

    def update(self, grads: Dict[str, torch.Tensor], state: Dict, params: Dict[str, torch.Tensor]
               ) -> Tuple[Optional[Dict[str, torch.Tensor]], Dict]:
        """grads and params: {path: tensor} of the trainable leaves.
        Returns (updates {path: u}, or None on a micro-step that applies
        nothing; the new state)."""
        k = self.cfg.grad_accum
        if k > 1:
            n = state["mini_step"]
            acc = {p: a + (grads[p] - a) / (n + 1) for p, a in state["acc"].items()}
            if n < k - 1:
                return None, dict(state, mini_step=n + 1, acc=acc)
            updates, inner = self._inner(acc, state, params)
            return updates, dict(inner, mini_step=0,
                                 acc={p: torch.zeros_like(a) for p, a in acc.items()})
        return self._inner(grads, state, params)

    def _inner(self, grads, state, params):
        cfg = self.cfg
        norm = global_norm(list(grads.values()))
        count = state["count"] + 1
        lr = -self.schedule(state["count"])
        bc1 = 1 - torch.tensor(cfg.beta1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(cfg.beta2, dtype=torch.float32) ** count
        mu, nu, updates = {}, {}, {}
        for p, g in grads.items():
            g = torch.where(norm < cfg.grad_clip, g,
                            (g / norm.to(g.dtype)) * _cast(cfg.grad_clip, g))
            mu[p] = _cast(1 - cfg.beta1, g) * g + _cast(cfg.beta1, g) * state["mu"][p]
            nu[p] = _cast(1 - cfg.beta2, g) * (g * g) + _cast(cfg.beta2, g) * state["nu"][p]
            u = (mu[p] / _cast(bc1, g)) / (torch.sqrt(nu[p] / _cast(bc2, g)) + _cast(1e-8, g))
            u = u + _cast(cfg.weight_decay, g) * params[p]
            updates[p] = _cast(lr, g) * u
        return updates, dict(state, count=count, mu=mu, nu=nu)


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x * x), each in the leaf's dtype
    (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(x * x) for x in leaves))


def make_optimizer(cfg: TrainConfig, params: Any) -> Tuple[Optimizer, Any]:
    mask = trainable_mask(params, cfg)
    paths = {p for p, m in leaves_with_path(mask).items() if m}
    return Optimizer(cfg, paths), mask


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def init_state(params: Any, cfg: TrainConfig) -> Tuple[TrainState, Optimizer]:
    opt, _ = make_optimizer(cfg, params)
    return TrainState(params=params, opt_state=opt.init(params), step=0), opt


def _batch(batch: Dict, dev: torch.device) -> Dict:
    return walkgpt._as_inputs(dev, **{k: batch[k] for k in BATCH_KEYS})


def loss_fn(params, model_cfg: WalkGPTConfig, batch: Dict, max_segs: int,
            remat: bool = False) -> Tuple[torch.Tensor, Dict]:
    """(loss, {metric: 0-d tensor}) of model_forward on a batch of
    tensors on the parameters' device."""
    out = walkgpt.model_forward(params, model_cfg, max_segs=max_segs, remat=remat,
                                **{k: batch[k] for k in BATCH_KEYS})
    return out.loss, {k: getattr(out, k).detach() for k in METRICS}


def _step(params, trainable: Set[str], opt: Optimizer, opt_state, batch, model_cfg,
          max_segs: int, remat: bool, device):
    """Differentiate the loss in the `trainable` leaves of params, update
    them. Returns (new params, new opt state, metrics)."""
    batch = _batch(batch, resolve_device(device))
    leaves = {p: x.detach().requires_grad_() for p, x in leaves_with_path(params).items()
              if p in trainable}
    loss, metrics = loss_fn(_replace(params, leaves), model_cfg, batch, max_segs, remat)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {p: torch.zeros_like(x) if g is None else g
             for (p, x), g in zip(leaves.items(), grads)}
    metrics["grad_norm"] = global_norm(list(grads.values())).detach()
    old = {p: x.detach() for p, x in leaves.items()}
    updates, opt_state = opt.update(grads, opt_state, old)
    if updates is not None:
        params = _replace(params, {p: (old[p] + u).to(old[p].dtype) for p, u in updates.items()})
    return params, opt_state, metrics


def train_step(state: TrainState, batch: Dict, *, opt: Optimizer, model_cfg: WalkGPTConfig,
               max_segs: int, remat: bool = False, device=None) -> Tuple[TrainState, Dict]:
    """One step over the full tree: the loss differentiated in the
    optimizer's trainable leaves only (the JAX step differentiates every
    leaf and zeroes the frozen ones' updates: the same result). batch:
    BATCH_KEYS as arrays or tensors, moved to `device` (default CUDA).
    Returns (new state, metrics: the loss terms and the gradients' global
    norm as 0-d tensors)."""
    params, opt_state, metrics = _step(state.params, opt.trainable, opt, state.opt_state,
                                       batch, model_cfg, max_segs, remat, device)
    return TrainState(params, opt_state, state.step + 1), metrics


def init_qlora_state(params: Any, cfg: TrainConfig) -> Tuple[TrainState, Optimizer, Any]:
    """Partition by the trainable policy and build the optimizer over the
    trainable subtree only. Returns (state, opt, frozen): state.params is
    the trainable subtree; pass `frozen` to every qlora_train_step (and to
    combine_params for evaluation or export).

    Refuses two configuration faults: a trainable integer leaf (the
    quantizer took a trained weight: quantize_llm needs
    quantize_lm_head=False and no quantize_embeddings), and a frozen W8A8
    "a8" projection (its activation round() has zero gradient, a wall for
    every adapter beneath it)."""
    mask = trainable_mask(params, cfg)
    m = leaves_with_path(mask)
    bad = [p for p, x in leaves_with_path(params).items()
           if m[p] and isinstance(x, torch.Tensor) and not x.is_floating_point()]
    if bad:
        raise ValueError(
            f"trainable leaves with integer dtype {bad[:4]}: keep trained groups dense "
            "(quantize_llm(..., quantize_lm_head=False), no quantize_embeddings) or "
            "freeze them")
    flags = [p for p in leaves_with_path(params) if p.endswith("/a8")]
    if flags:
        raise ValueError(
            f"W8A8 activation quantization present ({flags[0]} ...): its per-token "
            "round() has zero gradient; quantize the training base with "
            "act_quant=False (weight-only int8 / packed int4)")
    trainable, frozen = partition_params(params, mask)
    opt, _ = make_optimizer(cfg, trainable)
    return TrainState(params=trainable, opt_state=opt.init(trainable), step=0), opt, frozen


def qlora_train_step(state: TrainState, frozen: Any, batch: Dict, *, opt: Optimizer,
                     model_cfg: WalkGPTConfig, max_segs: int, remat: bool = False,
                     device=None) -> Tuple[TrainState, Dict]:
    """train_step over the trainable subtree; `frozen` rides along as a
    plain argument, never differentiated, never copied into the state."""
    params, opt_state, metrics = _step(combine_params(state.params, frozen), opt.trainable,
                                       opt, state.opt_state, batch, model_cfg, max_segs,
                                       remat, device)
    trainable = map_with_path(lambda p, x: x if p in opt.trainable else None, params)
    return TrainState(trainable, opt_state, state.step + 1), metrics
