"""The SFT train step (port of `padt_tpu/train/train_step.py`): the four PaDT
losses in one differentiable function, the optimizer, and the step
functions built from them.

`padt_loss` = token CE with the robust VP mask + bbox (GIoU + L1) + score
MSE + mask (dice + focal), with the warm-up substitution (the decoder reads
the picked VRT prototypes instead of the hidden states early in training).
The forward is `forward_train(remat=True)`: each text layer and, unless
frozen, each tower block is checkpointed, and attention and rope go through
their autograd Functions (H2 with LSE, H8/H9; H1 and its VJP).

Parameters are a nested dict of leaf tensors, as the JAX tree. The step
functions update them in place (`torch.optim` semantics), where the JAX
ones return a new tree and optimizer state.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import PaDTConfig
from ..models import padt as padt_model
from . import losses


class LossConfig(NamedTuple):
    """Static loss switches (reference PaDTSFTConfig flags)."""

    use_bbox_loss: bool = True
    use_score_loss: bool = True
    use_mask_loss: bool = True
    use_sft_vp_mask: bool = True
    use_warm_up: bool = True
    # `--freeze_vision_modules`: the tower runs without a graph
    freeze_vision: bool = False


def padt_loss(params, cfg: PaDTConfig, batch: Dict[str, torch.Tensor], prompt_length: int,
              canvas_hw: Tuple[int, int], lcfg: LossConfig, warmup) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics) of one batch; `warmup` (a bool or a 0-d bool
    tensor) feeds the decoder the prototypes instead of the hidden states."""
    lp = prompt_length
    lc = batch["input_ids"].shape[1] - lp
    logits, hidden, art = padt_model.forward_train(
        params, cfg, batch, logits_slice=(lp - 1, lc), remat=True,
        freeze_vision=lcfg.freeze_vision, split_logits=True,
    )
    sft = losses.sft_token_loss(
        logits, batch["input_ids"][:, lp:], batch["completion_mask"][:, lp:].float(),
        batch["vrt_penalty_mask"], cfg.text.vocab_size, use_vp_mask=lcfg.use_sft_vp_mask,
    )
    sft_loss = sft.mean()
    metrics = {"sft_loss": sft_loss}

    obj_sample = batch["obj_sample"].long()
    feats = hidden[obj_sample[:, None], batch["gather_pos"].long()]  # (N, K, D)
    if lcfg.use_warm_up and bool(warmup):
        feats = art.proto[obj_sample[:, None], batch["picked_patch_ids"].long()].to(feats.dtype)
    obj_valid = batch["obj_valid"].bool()
    dec = padt_model.vl_decode(
        params, cfg, feats, batch["vrt_counts"], obj_valid, obj_sample, art,
        canvas_hw=canvas_hw, compute_mask=lcfg.use_mask_loss,
    )

    total = sft_loss
    if lcfg.use_bbox_loss:
        bl = losses.bbox_losses(dec.pred_boxes, batch["gt_boxes"], obj_valid)
        total = total + bl["bbox_loss"]
        metrics.update(bbox_loss=bl["bbox_loss"], iou=bl["iou_mean"], giou=bl["giou_mean"])
        if lcfg.use_score_loss:
            sc = losses.score_loss(dec.pred_score, bl["giou"], obj_valid)
            total = total + sc
            metrics["score_loss"] = sc
    if lcfg.use_mask_loss:
        gt_mask = batch["gt_mask"]
        lm = batch["gt_mask_valid"] * obj_valid[:, None, None]  # invalid objects: empty loss masks
        ml = losses.dice_loss(dec.pred_mask, gt_mask, lm) + losses.sigmoid_focal_loss(dec.pred_mask, gt_mask, lm)
        total = total + ml
        metrics["mask_loss"] = ml
    metrics["loss"] = total
    return total, metrics


def train_step_launches(cfg: PaDTConfig, slot_layout: bool = True, freeze_vision: bool = True) -> Dict[str, int]:
    """The kernel wrappers one train step calls (its launches on the card).
    Per text layer: H2 twice (the forward and the checkpoint's recompute),
    H1 three times (forward, recompute and VJP), H8 and H9 once. The
    decoder's six rotary projections (two in each of its three blocks): H1
    forward and VJP. The frozen tower (the default, as `train_args`
    configures it) runs its forward once: H1 per block, H2 per full block
    and, on the window-slot layout, H3 per windowed block (H2 otherwise).
    The trained tower (`freeze_vision=False`, per-block remat) runs every
    block as a text layer runs: H1 three times, H2 twice (over its segment
    or slot ids), H8 and H9 once, and never H3."""
    nl, vc = cfg.text.num_hidden_layers, cfg.vision
    n_full = len(vc.fullatt_block_indexes)
    n_win = vc.depth - n_full
    if not freeze_vision:
        counts = {
            "rope_qk": 3 * nl + 3 * vc.depth + 2 * 6,
            "segment_flash_fwd": 2 * nl + 2 * vc.depth,
            "flash_bwd_dq": nl + vc.depth,
            "flash_bwd_dkv": nl + vc.depth,
        }
        return dict(counts, window_slot_attn=0) if slot_layout else counts
    counts = {
        "rope_qk": 3 * nl + vc.depth + 2 * 6,
        "segment_flash_fwd": 2 * nl + n_full + (0 if slot_layout else n_win),
        "flash_bwd_dq": nl,
        "flash_bwd_dkv": nl,
    }
    if slot_layout:
        counts["window_slot_attn"] = n_win
    return counts


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def flat_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """[(dotted key, leaf)] in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(flat_leaves(v, f"{prefix}{k}."))
        else:
            out.append((prefix + k, v))
    return out


def vision_frozen_mask(params):
    """True for every leaf under the top-level "vision" subtree (the module
    set `--freeze_vision_modules` freezes), False elsewhere."""
    def fill(tree, value):
        return {k: fill(v, value) if isinstance(v, dict) else value for k, v in tree.items()}

    return {k: fill(v, k == "vision") if isinstance(v, dict) else k == "vision" for k, v in params.items()}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _factored_dims(shape, min_dim_size_to_factor: int = 128) -> Optional[Tuple[int, int]]:
    """The two largest axes (second largest, largest), or None when the
    second largest is under `min_dim_size_to_factor` (optax's rule, with
    its numpy argsort)."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(torch.optim.Optimizer):
    """Adafactor as `optax.adafactor(multiply_by_parameter_scale=False,
    clipping_threshold=None, momentum=None, eps=1e-30)` configures it (not
    `torch.optim.Adafactor`, whose defaults differ): factored second
    moments for leaves whose two largest axes are both >= 128, else a full
    second moment; decay 1 - (t + 1)^-0.8; no momentum, no parameter scale;
    update = lr * g / sqrt(v) (+ weight_decay * p, not scaled by lr), then
    p -= update. Moments are kept in the parameter's dtype."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, eps: float = 1e-30,
                 decay_rate: float = 0.8, min_dim_size_to_factor: int = 128):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, eps=eps, decay_rate=decay_rate,
                                      min_dim_size_to_factor=min_dim_size_to_factor))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
                if not st:
                    st["step"] = 0
                    if dims is not None:
                        d1, d0 = dims
                        st["v_row"] = torch.zeros(np.delete(p.shape, d0).tolist(), dtype=p.dtype, device=p.device)
                        st["v_col"] = torch.zeros(np.delete(p.shape, d1).tolist(), dtype=p.dtype, device=p.device)
                    else:
                        st["v"] = torch.zeros_like(p)
                # optax evaluates the decay in float32
                decay = float(np.float32(1.0) - np.float32(st["step"] + 1) ** np.float32(-group["decay_rate"]))
                grad_sqr = g * g + group["eps"]
                if dims is not None:
                    d1, d0 = dims
                    v_row = (decay * st["v_row"] + (1.0 - decay) * grad_sqr.mean(dim=d0)).to(p.dtype)
                    v_col = (decay * st["v_col"] + (1.0 - decay) * grad_sqr.mean(dim=d1)).to(p.dtype)
                    st["v_row"], st["v_col"] = v_row, v_col
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                    update = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                else:
                    st["v"] = (decay * st["v"] + (1.0 - decay) * grad_sqr).to(p.dtype)
                    update = g * st["v"] ** -0.5
                update = update * group["lr"]
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p
                p.sub_(update.to(p.dtype))
                st["step"] += 1


def lr_schedule(learning_rate: float, warmup_steps: int = 0, total_steps: Optional[int] = None,
                schedule: str = "linear") -> Callable[[int], float]:
    """The learning rate at update `count` (0 for the first update), as the
    JAX package's optax schedules give it: linear decay to 0 over
    total_steps (with an optional linear warm-up), warm-up + cosine decay to
    0, or a constant."""
    if total_steps and schedule == "linear":
        if not warmup_steps:
            return lambda c: learning_rate * (1.0 - min(c, total_steps) / total_steps)
        decay = max(total_steps - warmup_steps, 1)

        def linear(c):
            if c < warmup_steps:
                return learning_rate * c / warmup_steps
            return learning_rate * (1.0 - min(c - warmup_steps, decay) / decay)

        return linear
    if total_steps and schedule == "cosine":
        def cosine(c):
            if c < warmup_steps:
                return learning_rate * c / warmup_steps
            t = max(total_steps - warmup_steps, 1)
            return learning_rate * 0.5 * (1.0 + math.cos(math.pi * min(c - warmup_steps, t) / t))

        return cosine
    return lambda c: learning_rate


class Optimizer:
    """optax.chain(clip_by_global_norm(max_grad_norm), masked(inner)) over
    the trainable leaves of a parameter tree, with the learning rate of
    `schedule(count)` through a `LambdaLR`: `step()` fills a missing grad
    with zeros (JAX differentiates every leaf), clips by the global norm
    (`clip_grad_norm_`), runs the inner optimizer, clears the grads,
    advances the schedule and returns the global norm before clipping.
    Frozen leaves are not in it and hold no state."""

    def __init__(self, leaves: List[Tuple[str, torch.Tensor]], inner: torch.optim.Optimizer,
                 schedule: Callable[[int], float], learning_rate: float, max_grad_norm: float):
        self.leaves = leaves
        self.inner = inner
        self.max_grad_norm = max_grad_norm
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            inner, lambda c: schedule(c) / learning_rate if learning_rate else 0.0)

    @property
    def count(self) -> int:
        """Updates applied so far."""
        return self.scheduler.last_epoch

    def scale_grads(self, factor: float) -> None:
        for _, p in self.leaves:
            if p.grad is not None:
                p.grad.mul_(factor)

    def step(self) -> torch.Tensor:
        params = [p for _, p in self.leaves]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        gnorm = torch.nn.utils.clip_grad_norm_(params, self.max_grad_norm)
        self.inner.step()
        self.inner.zero_grad(set_to_none=True)
        self.scheduler.step()
        return gnorm

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "scheduler": self.scheduler.state_dict(), "count": self.count}

    def load_state_dict(self, sd):
        self.inner.load_state_dict(sd["inner"])
        self.scheduler.load_state_dict(sd["scheduler"])


def make_optimizer(
    params,
    learning_rate: float = 2e-5,
    weight_decay: float = 0.0,
    max_grad_norm: float = 1.0,
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    schedule: str = "linear",
    optimizer: str = "adamw",
    frozen_mask=None,
) -> Optimizer:
    """AdamW (`torch.optim.AdamW`, moments in the parameter dtype as optax
    keeps them) or the optax-configured `Adafactor`, behind a global-norm
    clip and the JAX package's learning-rate schedule, over the leaves of `params` that `frozen_mask` (a tree of bools or
    a callable params -> tree; True = frozen) leaves trainable. Marks those
    leaves requires_grad and the frozen ones not."""
    frozen = frozen_mask(params) if callable(frozen_mask) else frozen_mask
    flags = dict(flat_leaves(frozen)) if frozen is not None else {}
    leaves = []
    for name, p in flat_leaves(params):
        trainable = not flags.get(name, False)
        p.requires_grad_(trainable)
        if trainable:
            leaves.append((name, p))
    tensors = [p for _, p in leaves]
    if optimizer == "adafactor":
        inner = Adafactor(tensors, lr=learning_rate, weight_decay=weight_decay)
    elif optimizer == "adamw":
        inner = torch.optim.AdamW(tensors, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return Optimizer(leaves, inner, lr_schedule(learning_rate, warmup_steps, total_steps, schedule), learning_rate,
                     max_grad_norm)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def _detached(metrics):
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: PaDTConfig, optimizer: Optimizer, prompt_length: int, canvas_hw: Tuple[int, int],
                    lcfg: LossConfig = LossConfig(), freeze_vision: bool = False):
    """step(params, batch, warmup) -> metrics (0-d tensors, grad_norm
    included); updates params and the optimizer state in place."""
    if freeze_vision:
        lcfg = lcfg._replace(freeze_vision=True)

    def step(params, batch, warmup):
        loss, metrics = padt_loss(params, cfg, batch, prompt_length, canvas_hw, lcfg, warmup)
        loss.backward()
        return dict(_detached(metrics), grad_norm=optimizer.step())

    return step


def make_eval_step(cfg: PaDTConfig, prompt_length: int, canvas_hw: Tuple[int, int], lcfg: LossConfig = LossConfig()):
    """eval_step(params, batch) -> metrics of the loss-only forward (no
    warm-up substitution)."""

    @torch.no_grad()
    def eval_step(params, batch):
        return _detached(padt_loss(params, cfg, batch, prompt_length, canvas_hw, lcfg, False)[1])

    return eval_step


def make_grad_and_apply_fns(cfg: PaDTConfig, optimizer: Optimizer, prompt_length: int, canvas_hw: Tuple[int, int],
                            lcfg: LossConfig = LossConfig(), freeze_vision: bool = False):
    """Gradient accumulation: grad_fn(params, batch, warmup) -> metrics adds
    one micro batch's gradients to the leaves' .grad (in the parameter
    dtype, as the JAX accumulator); apply_fn(num_micro) -> global norm
    averages them and applies the optimizer once."""
    if freeze_vision:
        lcfg = lcfg._replace(freeze_vision=True)

    def grad_fn(params, batch, warmup):
        loss, metrics = padt_loss(params, cfg, batch, prompt_length, canvas_hw, lcfg, warmup)
        loss.backward()
        return _detached(metrics)

    def apply_fn(num_micro: int):
        optimizer.scale_grads(1.0 / num_micro)
        return optimizer.step()

    return grad_fn, apply_fn
