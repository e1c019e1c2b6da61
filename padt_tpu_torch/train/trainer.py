"""SFT trainer (port of `padt_tpu/train/trainer.py`): sampler, train loop,
gradient accumulation, in-training eval, the frozen-tower feature cache,
checkpoints and metrics.

  - `repeat_random_sampler`: the reference RepeatRandomSampler schedule;
  - warm-up rule: prototype substitution while `epoch < num_epochs / 4 and
    global_step < warm_up_max_steps`;
  - checkpoints: `torch.save` of the parameters, the optimizer state, the
    step and the host batch generator's state into `checkpoint-<step>/
    state.pt`, plus `meta.json` (step and config), in place of orbax;
    `train(resume=True)` restores the latest and continues with the batch
    after the last one trained, so a resumed run equals an uninterrupted
    one (the JAX trainer replays the interrupted epoch from its start);
  - metrics: one JSON line per logged step in `output_dir/metrics.jsonl`.

One device: `mesh_*` sizes other than 1 raise (multi-card training is a
later part of the port). The trainer owns `params`: its trainable leaves
get requires_grad and are updated in place; under `freeze_vision_modules`
the tower's leaves are never written.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import PaDTConfig
from ..models import padt as padt_model
from ..vrt.processor import VisionTextProcessor
from .data import build_train_batch
from .prefetch import BatchPrefetcher
from .train_step import (
    LossConfig, make_eval_step, make_grad_and_apply_fns, make_optimizer, make_train_step, vision_frozen_mask,
)


def repeat_random_sampler(
    num_samples: int,
    batch_size: int,
    seed: Optional[int] = None,
    mini_repeat_count: int = 1,
    repeat_count: int = 1,
    gradient_accumulation_steps: int = 1,
) -> Iterator[int]:
    """Reference RepeatRandomSampler semantics (padt_sft_trainer.py:87-96)."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(num_samples).tolist()
    chunks = [perm[i : i + batch_size] for i in range(0, len(perm) // batch_size * batch_size, batch_size)]
    for chunk in chunks:
        for _ in range(repeat_count):
            for acc in range(gradient_accumulation_steps):
                for idx in chunk[acc::gradient_accumulation_steps]:
                    for _ in range(mini_repeat_count):
                        yield idx


@dataclass
class TrainArgs:
    """PaDTSFTConfig subset, with the JAX trainer's fields and defaults."""

    learning_rate: float = 2e-5
    per_device_train_batch_size: int = 16
    gradient_accumulation_steps: int = 1
    num_train_epochs: float = 1.0
    max_grad_norm: float = 1.0
    weight_decay: float = 0.0
    warmup_steps: int = 0
    seed: int = 42
    save_steps: int = 100
    logging_steps: int = 1
    eval_strategy: str = "no"  # "no" | "steps"
    eval_steps: int = 100
    per_device_eval_batch_size: Optional[int] = None  # defaults to the train batch size
    output_dir: str = "outputs/padt_sft"
    use_mask_loss: bool = False
    use_bbox_loss: bool = True
    use_score_loss: bool = True
    use_sft_vp_mask: bool = True
    use_warm_up: bool = True
    warm_up_max_steps: int = 300
    random_select_patch: bool = False
    random_select_patch_num: int = 5
    freeze_vision_modules: bool = False
    # the frozen tower's outputs computed once per sample, kept on the host
    # and fed back as `vis_*` batch keys (exact under freeze_vision_modules)
    cache_vision_features: bool = False
    vis_cache_dtype: str = "bf16"  # "bf16" (exact) | "int8" (per-row quantized merged / high_res)
    optimizer: str = "adamw"  # "adamw" | "adafactor"
    prompt_bucket: Optional[int] = None
    completion_bucket: Optional[int] = None
    patch_bucket: Optional[int] = None
    canvas_hw: Optional[Tuple[int, int]] = None
    mesh_data: int = 1
    mesh_fsdp: int = 1
    mesh_tensor: int = 1


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class PaDTTrainer:
    def __init__(
        self,
        cfg: PaDTConfig,
        params,
        processor: VisionTextProcessor,
        args: TrainArgs,
        dataset: Sequence[Dict],
        images: Optional[Sequence[Any]] = None,  # preloaded images by index (else loaded from paths)
        eval_dataset: Optional[Sequence[Dict]] = None,
        eval_images: Optional[Sequence[Any]] = None,
        device="cuda",
    ):
        if (args.mesh_data, args.mesh_fsdp, args.mesh_tensor) != (1, 1, 1):
            raise NotImplementedError("the port trains on one device: mesh_data, mesh_fsdp and mesh_tensor must be 1")
        if args.cache_vision_features and not args.freeze_vision_modules:
            raise ValueError(
                "cache_vision_features requires freeze_vision_modules: cached features skip the tower "
                "graph, so an unfrozen tower would silently train with zero vision gradients"
            )
        self.cfg = cfg
        self.args = args
        self.processor = processor
        self.dataset = dataset
        self.images = images
        self.eval_dataset = eval_dataset
        self.eval_images = eval_images
        self.device = torch.device(device)
        # the trainer owns the tree: leaves on the device, outside any graph
        self.params = _tree_map(lambda t: t.detach().to(self.device), params)
        # cache_vision_features: the cached step reads only params["proto"],
        # so the tower stays out of the step tree; it fills the cache, moves
        # to the host once every sample is cached, and rejoins on save
        self._tower_dev = None
        self._tower_host = None
        if args.cache_vision_features:
            self._tower_dev = self.params["vision"]
            self.params = dict(self.params, vision={})
        n_batches_per_epoch = len(dataset) // (args.per_device_train_batch_size * args.gradient_accumulation_steps)
        if n_batches_per_epoch == 0:
            print(f"WARNING: dataset ({len(dataset)} samples) smaller than one effective batch — no train steps will run")
        self.total_steps = max(int(n_batches_per_epoch * args.num_train_epochs), 1)
        self.optimizer = make_optimizer(
            self.params,
            learning_rate=args.learning_rate,
            weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm,
            warmup_steps=args.warmup_steps,
            total_steps=self.total_steps,
            optimizer=args.optimizer,
            frozen_mask=vision_frozen_mask if args.freeze_vision_modules else None,
        )
        self._vis_cache: Dict[Tuple, Dict[str, torch.Tensor]] = {}
        self.global_step = 0
        self._rng_state = None  # the batch generator's state after the last batch trained
        self._fns: Dict[Tuple, Any] = {}
        self.metrics_log: List[Dict] = []
        os.makedirs(args.output_dir, exist_ok=True)
        self._metrics_file = os.path.join(args.output_dir, "metrics.jsonl")

    # ------------------------------------------------------------------
    def _lcfg(self) -> LossConfig:
        a = self.args
        return LossConfig(
            use_bbox_loss=a.use_bbox_loss, use_score_loss=a.use_score_loss, use_mask_loss=a.use_mask_loss,
            use_sft_vp_mask=a.use_sft_vp_mask, use_warm_up=a.use_warm_up,
        )

    def _fn(self, kind: str, prompt_length: int, canvas_hw: Tuple[int, int]):
        key = (kind, prompt_length, canvas_hw)
        if key not in self._fns:
            frozen = self.args.freeze_vision_modules
            if kind == "step":
                fn = make_train_step(self.cfg, self.optimizer, prompt_length, canvas_hw, self._lcfg(), frozen)
            elif kind == "accum":
                fn = make_grad_and_apply_fns(self.cfg, self.optimizer, prompt_length, canvas_hw, self._lcfg(), frozen)
            else:  # freeze_vision also gates run_vision's cached vis_* path
                fn = make_eval_step(self.cfg, prompt_length, canvas_hw, self._lcfg()._replace(freeze_vision=frozen))
            self._fns[key] = fn
        return self._fns[key]

    def _to_device(self, model: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(self.device)
                for k, v in model.items()}

    # ------------------------------------------------------------------
    def _with_vis_cache(self, tb, split: str) -> Dict[str, Any]:
        """cache_vision_features: the batch with its tower inputs replaced by
        each sample's cached tower outputs, computing (in one batched call)
        and caching on the host any that are missing."""
        if not self.args.cache_vision_features:
            return tb.model
        idx = tb.meta.get("batch_idx")
        if idx is None:
            raise ValueError("cache_vision_features needs per-sample cache keys: pass batch_idx= to build_train_batch")
        keys = [(split, int(i)) for i in idx]
        quant = "int8" if self.args.vis_cache_dtype == "int8" else "none"
        if any(k not in self._vis_cache for k in keys):
            if self._tower_dev is None:
                raise RuntimeError(
                    "vision-feature cache miss after the tower was offloaded: a sample outside the "
                    "train/eval datasets reached _with_vis_cache (cache keys are (split, index))"
                )
            vb = self._to_device({k: tb.model[k] for k in padt_model._VISION_BATCH_KEYS if k in tb.model})
            feats = padt_model.vision_features(dict(self.params, vision=self._tower_dev), self.cfg, vb, quant=quant)
            host = {k: v.cpu() for k, v in feats.items()}
            for row, key in enumerate(keys):
                self._vis_cache[key] = {k: host[k][row] for k in host}
            # every sample cached: the tower never runs again; free the card
            if len(self._vis_cache) >= len(self.dataset) + len(self.eval_dataset or []):
                self._tower_host = _tree_map(lambda t: t.cpu(), self._tower_dev)
                self._tower_dev = None
        model = {k: v for k, v in tb.model.items() if k not in padt_model._VISION_ONLY_KEYS}
        for name in padt_model.vision_cache_keys(quant):
            model[name] = torch.stack([self._vis_cache[k][name] for k in keys])
        return model

    def _build(self, samples_idx, dataset, images, rng, **kw):
        a = self.args
        return build_train_batch(
            [dataset[i] for i in samples_idx], self.processor, self.cfg, rng,
            images=[images[i] for i in samples_idx] if images is not None else None,
            batch_idx=samples_idx, prompt_bucket=a.prompt_bucket, completion_bucket=a.completion_bucket,
            patch_bucket=a.patch_bucket, canvas_hw=a.canvas_hw, use_mask_targets=a.use_mask_loss, **kw,
        )

    # ------------------------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        """The loss forward over the validation split (a seeded shuffle, full
        batches only); the metrics averaged over batches."""
        assert self.eval_dataset, "no eval_dataset provided"
        a = self.args
        bs = a.per_device_eval_batch_size or a.per_device_train_batch_size
        order = list(repeat_random_sampler(len(self.eval_dataset), batch_size=1, seed=a.seed))
        rng = np.random.RandomState(a.seed)
        metric_sum, n_batches = None, 0
        for bi in range(0, len(order) // bs * bs, bs):
            tb = self._build(order[bi : bi + bs], self.eval_dataset, self.eval_images, rng)
            batch = self._to_device(self._with_vis_cache(tb, "eval"))
            m = self._fn("eval", tb.prompt_length, tb.meta["canvas_hw"])(self.params, batch)
            metric_sum = m if metric_sum is None else {k: metric_sum[k] + m[k] for k in m}
            n_batches += 1
        if n_batches == 0:
            return {}
        return {f"eval_{k}": float(v) / n_batches for k, v in metric_sum.items()}

    # ------------------------------------------------------------------
    def _produce(self, rng):
        """Host-side batch building (run ahead on a prefetch thread): yields
        (micro batches, warm-up flag, epoch fraction, generator state after
        them), starting after the last batch trained."""
        a = self.args
        micro, ga = a.per_device_train_batch_size, a.gradient_accumulation_steps
        epoch_len = len(self.dataset) // (micro * ga)
        step_counter = self.global_step
        start_epoch = step_counter // max(epoch_len, 1)
        skip = step_counter - start_epoch * epoch_len
        for epoch in range(start_epoch, int(np.ceil(a.num_train_epochs))):
            idxs = list(repeat_random_sampler(len(self.dataset), micro * ga, seed=a.seed + epoch,
                                              gradient_accumulation_steps=ga))
            for bi in range(0, len(idxs) // (micro * ga) * (micro * ga), micro * ga):
                if skip > 0:
                    skip -= 1
                    continue
                if step_counter >= self.total_steps:
                    return
                epoch_frac = step_counter / max(epoch_len, 1)
                warmup = a.use_warm_up and epoch_frac < a.num_train_epochs / 4 and step_counter < a.warm_up_max_steps
                micro_batches = [
                    self._build(idxs[bi + mi * micro : bi + (mi + 1) * micro], self.dataset, self.images, rng,
                                random_select_patch=a.random_select_patch,
                                random_select_patch_num=a.random_select_patch_num)
                    for mi in range(ga)
                ]
                step_counter += 1
                yield micro_batches, warmup, epoch_frac, rng.get_state()

    def _log(self, metrics: Dict[str, Any]) -> None:
        line = json.dumps({k: (round(v, 5) if isinstance(v, float) else v) for k, v in metrics.items()})
        print(line)
        with open(self._metrics_file, "a") as f:
            f.write(line + "\n")

    def train(self, resume: bool = False):
        a = self.args
        if resume:
            self.load_latest_checkpoint()
        rng = np.random.RandomState(a.seed)
        if self._rng_state is not None:
            rng.set_state(self._rng_state)
        ga = a.gradient_accumulation_steps
        for micro_batches, warmup, epoch_frac, rng_state in BatchPrefetcher(self._produce(rng), depth=2):
            t0 = time.perf_counter()
            if ga == 1:
                tb = micro_batches[0]
                batch = self._to_device(self._with_vis_cache(tb, "train"))
                m = self._fn("step", tb.prompt_length, tb.meta["canvas_hw"])(self.params, batch, bool(warmup))
                metrics = {k: float(v) for k, v in m.items()}
            else:
                metric_sum = None
                for tb in micro_batches:
                    grad_fn, apply_fn = self._fn("accum", tb.prompt_length, tb.meta["canvas_hw"])
                    batch = self._to_device(self._with_vis_cache(tb, "train"))
                    m = grad_fn(self.params, batch, bool(warmup))
                    metric_sum = m if metric_sum is None else {k: metric_sum[k] + m[k] for k in m}
                gnorm = apply_fn(ga)
                metrics = {k: float(v) / ga for k, v in metric_sum.items()}
                metrics["grad_norm"] = float(gnorm)
            metrics["step_time_s"] = time.perf_counter() - t0
            self.global_step += 1
            self._rng_state = rng_state
            metrics.update(step=self.global_step, epoch=round(epoch_frac, 4), warmup=bool(warmup))
            self.metrics_log.append(metrics)
            if self.global_step % a.logging_steps == 0:
                self._log(metrics)
            if a.eval_strategy == "steps" and self.eval_dataset and self.global_step % a.eval_steps == 0:
                em = self.evaluate()
                em["step"] = self.global_step
                self.metrics_log.append(em)
                self._log(em)
            if self.global_step % a.save_steps == 0:
                self.save_checkpoint()
        self.save_checkpoint()
        return self.metrics_log

    # ------------------------------------------------------------------
    def _full_params(self):
        """The whole tree, the offloaded tower re-attached."""
        if not self.args.cache_vision_features:
            return self.params
        tower = self._tower_dev if self._tower_dev is not None else self._tower_host
        return dict(self.params, vision=tower)

    def save_checkpoint(self, path: Optional[str] = None):
        path = path or os.path.join(os.path.abspath(self.args.output_dir), f"checkpoint-{self.global_step}")
        os.makedirs(path, exist_ok=True)
        rng = None
        if self._rng_state is not None:
            name, keys, pos, has_gauss, gauss = self._rng_state
            rng = {"name": name, "keys": torch.as_tensor(keys.astype(np.int64)), "pos": int(pos),
                   "has_gauss": int(has_gauss), "gauss": float(gauss)}
        state = {
            "params": _tree_map(lambda t: t.detach(), self._full_params()),
            "opt_state": self.optimizer.state_dict(),
            "step": self.global_step,
            "rng": rng,
        }
        torch.save(state, os.path.join(path, "state.pt"))
        with open(os.path.join(path, "meta.json"), "w") as f:
            f.write(json.dumps({"step": self.global_step, "config": json.loads(self.cfg.to_json())}))

    def load_latest_checkpoint(self) -> bool:
        out = os.path.abspath(self.args.output_dir)
        if not os.path.isdir(out):
            return False
        cands = [d for d in os.listdir(out) if d.startswith("checkpoint-")]
        if not cands:
            return False
        self.load_checkpoint(os.path.join(out, max(cands, key=lambda d: int(d.split("-")[1]))))
        return True

    def load_checkpoint(self, path: str):
        """Copy the saved parameters into the trainer's own leaves (the
        optimizer keeps its references), then restore the optimizer state,
        the step and the batch generator's state."""
        state = torch.load(os.path.join(os.path.abspath(path), "state.pt"), map_location="cpu", weights_only=True)

        def copy_into(dst, src):
            for k, v in dst.items():
                if isinstance(v, dict):
                    copy_into(v, src[k])
                else:
                    with torch.no_grad():
                        v.copy_(src[k])

        copy_into(self._full_params(), state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        rng = state.get("rng")
        self._rng_state = None if rng is None else (
            rng["name"], rng["keys"].numpy().astype(np.uint32), rng["pos"], rng["has_gauss"], rng["gauss"])
        with open(os.path.join(path, "meta.json")) as f:
            self.global_step = json.load(f)["step"]
