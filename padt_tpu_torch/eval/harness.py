"""Inference harness on PyTorch (port of `padt_tpu/eval/harness.py`):
image + prompt -> completion, boxes, scores, masks, with the same result
types, through fixed batches (`run_batch`) or the continuous-batching serve
engine (`run_stream`), and `infer_dataset` over a dataset in either mode
with the JAX package's JSONL files.

Differences from the JAX engine, all deliberate:
  - the pixel wire format (compact uint8 rows or f32 rows) is chosen per
    call: raw images are turned into `ProcessedImage`s here, so the shared
    processor is never mutated;
  - the batch carries whichever pixel key the processor produced
    (`pixel_patches` or `pixel_patches_u8`), and both are accepted;
  - the mask upsample is half-pixel bilinear (`F.interpolate(mode="bilinear",
    align_corners=False)`), the interpolation of `cv2.INTER_LINEAR`, so the
    port does not need OpenCV;
  - `infer_dataset` runs as one process (rank 0 of 1): multi-process
    sharding comes with the parallel slice.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import PaDTConfig
from ..models import padt as padt_model
from ..preprocess.vision_process import ProcessedImage, ensure_min_28, process_image, resize_max_side
from ..utils.profiling import Recorder
from ..vrt.parser import pack_objects, parse_vrt_completions
from ..vrt.processor import VisionTextProcessor
from . import rle as rle_codec


@dataclass
class ObjectResult:
    label: str
    score: float
    bbox_xywh_px: Tuple[float, float, float, float]
    mask_rle: Optional[Dict]
    vrt_string: str


@dataclass
class SampleResult:
    completion: str
    objects: List[ObjectResult]


def _clean(s: str) -> str:
    return s.replace("<|endoftext|>", "").replace("<|im_end|>", "")


def upsample_logits(logit: np.ndarray, w_px: int, h_px: int) -> np.ndarray:
    """(h, w) f32 logits -> (h_px, w_px) by half-pixel bilinear
    interpolation (cv2.resize INTER_LINEAR's sampling)."""
    t = torch.as_tensor(np.ascontiguousarray(logit, np.float32))[None, None]
    up = F.interpolate(t, size=(int(h_px), int(w_px)), mode="bilinear", align_corners=False)
    return up[0, 0].numpy()


class InferenceEngine:
    def __init__(
        self,
        params,
        cfg: PaDTConfig,
        processor: VisionTextProcessor,
        max_new_tokens: int = 1024,
        canvas_hw: Optional[Tuple[int, int]] = None,
        compute_mask: bool = True,
        compact_pixels: bool = True,
    ):
        self.params = params
        self.cfg = cfg
        self.processor = processor
        # PADT_COMPACT_PIXELS=0 restores the f32 row format, as in the JAX
        # engine; the choice stays on the engine (the processor is shared)
        self.compact_pixels = compact_pixels and os.environ.get("PADT_COMPACT_PIXELS", "1") == "1"
        self.max_new_tokens = max_new_tokens
        side = int(cfg.max_image_patches**0.5) + 1
        self.canvas_hw = canvas_hw or (side, side)
        self.compute_mask = compute_mask
        self.device = params["text"]["embed"].device
        self._serve_cache: Dict[Tuple, Any] = {}
        self._stream_stats: Optional[Dict[str, Any]] = None
        self._recorder = Recorder()  # run_stream's host spans until pop_stream_stats
        self._stream_calls = 0

    def _to_device(self, data: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in data.items():
            t = torch.as_tensor(np.asarray(v), device=self.device)
            out[k] = t.to(torch.bfloat16) if k == "pixel_patches" else t
        return out

    def _processed(self, images: List[Any]) -> List[Any]:
        """Raw images -> `ProcessedImage`s in this engine's pixel wire format."""
        proc = self.processor
        return [
            img if img is None or isinstance(img, ProcessedImage)
            else process_image(img, proc.min_pixels, proc.max_pixels, u8_rows=self.compact_pixels)
            for img in images
        ]

    def _image_sizes(self, images: List[Any]) -> List[Tuple[int, int]]:
        """(W, H) px of the model input of each image."""
        sizes = []
        for img in images:
            if isinstance(img, ProcessedImage):
                _, h, w = img.grid_thw
                sizes.append((w * self.cfg.vision.patch_size, h * self.cfg.vision.patch_size))
            else:
                sizes.append(img.size)
        return sizes

    def _serve_engine(self, **kw):
        """One ServeEngine per constructor-argument set, reused across calls
        (its prefix-KV LRU persists); at most 2 live engines, each holding an
        n_slots x capacity int8 KV pool. The engine packs its own copy of the
        text weights and of the tower's MLP; the harness adopts it, so
        `run_batch` then runs on the packed weights and the unfused stacks
        are not kept alive beside them."""
        from ..serve import ServeEngine

        key = tuple(sorted(kw.items()))
        eng = self._serve_cache.get(key)
        if eng is None:
            while len(self._serve_cache) >= 2:
                self._serve_cache.pop(next(iter(self._serve_cache)))
            eng = ServeEngine(
                self.params, self.cfg, max_new_tokens=self.max_new_tokens,
                collect_hidden=True, keep_artifacts=True, **kw,
            )
            self.params = eng.params
            self._serve_cache[key] = eng
        return eng

    @torch.no_grad()
    def run_batch(
        self,
        prompts: List[str],
        images: List[Any],
        image_sizes: Optional[List[Tuple[int, int]]] = None,  # (W, H) px of the model input
        patch_bucket: Optional[int] = None,
        prompt_bucket: Optional[int] = None,
    ) -> List[SampleResult]:
        cfg, proc = self.cfg, self.processor
        if image_sizes is None:
            image_sizes = self._image_sizes(images)
        images = self._processed(images)
        batch = proc.build_batch(
            prompts, images, patch_bucket=patch_bucket or cfg.max_image_patches,
            prompt_bucket=prompt_bucket,
        )
        tbatch = self._to_device(batch.data)
        deltas = torch.as_tensor(batch.rope_deltas, device=self.device)
        out = padt_model.generate(self.params, cfg, tbatch, self.max_new_tokens, deltas)
        return self._postprocess(out.tokens.cpu().numpy(), out.hidden, out.artifacts, image_sizes)

    def _host_batch(self, data: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """A processor batch as host-side request leaves: pixel rows as a bf16
        CPU tensor, everything else numpy. The engine moves one admission
        bucket at a time to the card."""
        return {
            k: torch.as_tensor(np.asarray(v)).to(torch.bfloat16) if k == "pixel_patches" else np.asarray(v)
            for k, v in data.items()
        }

    def build_stream_requests(
        self,
        prompts: List[str],
        images: List[Any],
        patch_bucket: Optional[int] = None,
        prompt_bucket: Optional[int] = None,
    ):
        """Host-only request construction for `run_stream` (tokenize, image-pad
        expansion, M-RoPE, padding); returns `(requests, prompt_bucket)`, to
        pass as `run_stream(prebuilt=...)`. Without a prompt_bucket, each
        request is rounded up to its own multiple of 128 (at most 3 distinct
        buckets) and the largest sizes the KV capacity."""
        from ..serve import Request

        cfg, proc = self.cfg, self.processor
        pb = patch_bucket or cfg.max_image_patches
        images = self._processed(images)
        batches = [proc.build_batch([p], [img], patch_bucket=pb, prompt_bucket=prompt_bucket) for p, img in zip(prompts, images)]
        if prompt_bucket is None:
            lens = [b.data["input_ids"].shape[1] for b in batches]
            ups = sorted({-(-l // 128) * 128 for l in lens})
            if len(ups) > 3:  # bound the number of prefill shapes: 3 quantiles
                ups = sorted({ups[0], ups[len(ups) // 2], ups[-1]})
            pick = lambda l: next(u for u in ups if u >= l)
            prompt_bucket = ups[-1]
            batches = [
                b if b.data["input_ids"].shape[1] == pick(lens[j])
                else proc.build_batch([prompts[j]], [images[j]], patch_bucket=pb, prompt_bucket=pick(lens[j]))
                for j, b in enumerate(batches)
            ]
        reqs = [
            Request(batch=self._host_batch(b.data), rope_delta=int(b.rope_deltas[0]), max_new_tokens=self.max_new_tokens, uid=i)
            for i, b in enumerate(batches)
        ]
        return reqs, prompt_bucket

    @torch.no_grad()
    def run_stream(
        self,
        prompts: List[str],
        images: List[Any],
        image_sizes: Optional[List[Tuple[int, int]]] = None,
        n_slots: int = 16,
        prefill_bucket: int = 4,
        chunk_steps: int = 8,
        prompt_bucket: Optional[int] = None,
        patch_bucket: Optional[int] = None,
        share_prefix: bool = False,
        prefix_cache_entries: int = 8,
        suffix_bucket: Optional[int] = None,
        prefix_keys: Optional[List[Any]] = None,
        prebuilt: Optional[Tuple[List[Any], int]] = None,  # build_stream_requests output
    ) -> List[SampleResult]:
        """`run_batch` semantics through the continuous-batching serve engine:
        requests flow through a slot-recycled decode pool, then the same
        parse -> vl_decode tail runs on the completions' hidden states and
        per-request vision artifacts.

        share_prefix=True: prompts over the same image (the same object, or
        equal `prefix_keys[i]`; pass stable keys such as file paths when
        calling in a loop, since the engine's prefix-KV LRU outlives the call)
        share one prefix prefill, and each request runs only its query-text
        suffix. Prompts whose suffix exceeds `suffix_bucket` (default 128)
        tokens take the full-prompt path."""
        cfg = self.cfg
        rec = self._recorder
        if image_sizes is None:
            image_sizes = self._image_sizes(images)
        pb = patch_bucket or cfg.max_image_patches
        if not share_prefix:
            if prebuilt is not None:
                reqs, prompt_bucket = prebuilt
            else:
                with rec.span("stream.build"):
                    reqs, prompt_bucket = self.build_stream_requests(prompts, images, patch_bucket=pb, prompt_bucket=prompt_bucket)
            eng = self._serve_engine(
                n_slots=min(n_slots, len(reqs)), prompt_len=prompt_bucket,
                prefill_bucket=prefill_bucket, chunk_steps=chunk_steps, patch_bucket=pb,
            )
        else:
            with rec.span("stream.build"):
                reqs, prompt_len, sbucket = self._prefix_requests(prompts, images, pb, prompt_bucket, suffix_bucket, prefix_keys)
            eng = self._serve_engine(
                n_slots=min(n_slots, len(reqs)), prompt_len=prompt_len,
                prefill_bucket=prefill_bucket, chunk_steps=chunk_steps,
                patch_bucket=pb, suffix_bucket=sbucket, prefix_cache_entries=prefix_cache_entries,
            )
        comps, sstats = eng.run(reqs, rec=rec)
        with rec.span("stream.tail"):
            out = self._stream_tail(comps, image_sizes)
        self._record_stream_stats(sstats)
        return out

    def _prefix_requests(self, prompts, images, pb, prompt_bucket, suffix_bucket, prefix_keys):
        """run_stream(share_prefix=True)'s requests: one SharedPrefix per image
        key (prefix lengths rounded to at most 3 multiples of 128, or the
        pinned prompt_bucket), the suffix ids per prompt, and full-prompt
        requests for the rest. Returns (requests, prompt_len, suffix_bucket)."""
        from ..serve import Request, SharedPrefix

        proc = self.processor
        images = self._processed(images)
        sfx = [np.asarray(proc.build_suffix_ids(p), np.int64) for p in prompts]
        shared = [i for i in range(len(prompts)) if 1 <= len(sfx[i]) <= (suffix_bucket or 128)]
        sbucket = suffix_bucket or -(-max([len(sfx[i]) for i in shared] or [32]) // 32) * 32
        if prefix_keys is not None:
            pkey = lambda i: prefix_keys[i]
        else:
            # identity keys hold only within this call: the LRU outlives it and
            # CPython reuses the ids of freed objects, so salt them per call
            self._stream_calls += 1
            salt = self._stream_calls
            pkey = lambda i: (salt, id(images[i]))
        nat: Dict[Any, Any] = {}
        for i in shared:
            if pkey(i) not in nat:
                nat[pkey(i)] = (images[i], proc.build_prefix_batch(images[i], patch_bucket=pb))
        lens = sorted({b.data["input_ids"].shape[1] for _, b in nat.values()} or {128})
        if prompt_bucket is not None:
            ups = [prompt_bucket]  # one pinned prefix bucket; longer prefixes fall back
            shared = [i for i in shared if nat[pkey(i)][1].data["input_ids"].shape[1] <= prompt_bucket]
        else:
            ups = sorted({-(-l // 128) * 128 for l in lens})
            if len(ups) > 3:
                ups = sorted({ups[0], ups[len(ups) // 2], ups[-1]})
        pick = lambda l: next(u for u in ups if u >= l)
        prefixes: Dict[Any, Any] = {}
        for k, (img, b) in nat.items():
            if b.data["input_ids"].shape[1] > ups[-1]:
                continue
            want = pick(b.data["input_ids"].shape[1])
            if want != b.data["input_ids"].shape[1]:
                b = proc.build_prefix_batch(img, prefix_bucket=want, patch_bucket=pb)
            prefixes[k] = SharedPrefix(key=k, batch=self._host_batch(b.data), rope_delta=int(b.rope_deltas[0]))
        shared_set = set(shared)
        reqs = []
        for i in range(len(prompts)):
            if i in shared_set:
                reqs.append(Request(prefix=prefixes[pkey(i)], suffix_ids=sfx[i], max_new_tokens=self.max_new_tokens, uid=i))
                continue
            fb = proc.build_batch([prompts[i]], [images[i]], patch_bucket=pb)  # suffix too long: full prompt
            l = fb.data["input_ids"].shape[1]
            if l % 128:
                fb = proc.build_batch([prompts[i]], [images[i]], patch_bucket=pb, prompt_bucket=-(-l // 128) * 128)
            reqs.append(Request(batch=self._host_batch(fb.data), rope_delta=int(fb.rope_deltas[0]), max_new_tokens=self.max_new_tokens, uid=i))
        # adjacent same-image admissions maximize prefix-LRU hits
        reqs.sort(key=lambda q: (q.prefix is None, q.prefix.key if q.prefix else 0))
        fb_max = max((q.batch["input_ids"].shape[1] for q in reqs if q.batch is not None), default=0)
        return reqs, max(ups[-1] + sbucket, fb_max), sbucket

    def _record_stream_stats(self, sstats):
        """Accumulate the serve engine's device prefill / decode seconds and
        its counters (every int field of `ServeStats`) across run_stream
        calls, until `pop_stream_stats`."""
        counts = [f.name for f in fields(sstats) if isinstance(getattr(sstats, f.name), int)]
        acc = self._stream_stats
        if acc is None:
            acc = self._stream_stats = {"engine_prefill_s": 0.0, "engine_decode_s": 0.0, **dict.fromkeys(counts, 0)}
        acc["engine_prefill_s"] += sstats.prefill_s
        acc["engine_decode_s"] += sstats.decode_s
        for k in counts:
            acc[k] += getattr(sstats, k)

    def pop_stream_stats(self) -> Optional[Dict[str, Any]]:
        """run_stream's split since the last pop (None without a call):
        build_s / run_s / tail_s, the host seconds of the spans
        `stream.build` (request construction), `serve.run` (the serve
        engine's run) and `stream.tail` (parse + vl_decode + masks); the
        engine's device prefill / decode seconds and its counters
        (`ServeStats`); `host_s` / `host_n`, every span name's host seconds
        and count; and `spans`, the span list, where tracing was on
        when the last call's outermost spans opened (`utils.profiling`)."""
        acc, self._stream_stats = self._stream_stats, None
        rec, self._recorder = self._recorder, Recorder()
        if acc is None:
            return None
        host = rec.seconds()
        out = {"build_s": host.get("stream.build", 0.0), "run_s": host.get("serve.run", 0.0),
               "tail_s": host.get("stream.tail", 0.0), **acc, "host_s": host, "host_n": dict(rec.counts)}
        if rec.spans is not None:
            out["spans"] = rec.span_tuples()
        return out

    @torch.no_grad()
    def _stream_tail(self, comps, image_sizes) -> List[SampleResult]:
        """Completions -> padded token / hidden / artifact stacks -> the
        standard parse + vl_decode postprocess."""
        comps.sort(key=lambda c: c.uid)
        tokens = np.full((len(comps), self.max_new_tokens), self.cfg.pad_token_id, np.int64)
        for i, c in enumerate(comps):
            tokens[i, : c.n_gen] = c.tokens
        hidden = torch.stack([c.hidden for c in comps])
        art = type(comps[0].artifacts)(*(torch.cat(xs) for xs in zip(*[c.artifacts for c in comps])))
        return self._postprocess(tokens, hidden, art, image_sizes)

    @torch.no_grad()
    def _postprocess(self, tokens, hidden, art, image_sizes) -> List[SampleResult]:
        cfg, proc = self.cfg, self.processor
        b = tokens.shape[0]
        token_strs = [proc.token_strings(tokens[i]) for i in range(b)]
        parsed = parse_vrt_completions(token_strs, tokens, cfg.text.vocab_size)
        objects = parsed.all_objects
        results = [SampleResult(completion=_clean(parsed.completions[i]), objects=[]) for i in range(b)]
        if not objects:
            return results

        n_max = -(-max(cfg.max_objects, len(objects)) // cfg.max_objects) * cfg.max_objects
        obj_sample, gather_pos, counts, valid = pack_objects(objects, n_max, cfg.max_vrt_per_object)
        dev = hidden.device
        obj_sample_t = torch.as_tensor(obj_sample, device=dev).long()
        feats = hidden[obj_sample_t[:, None], torch.as_tensor(gather_pos, device=dev).long()]
        dec = padt_model.vl_decode(
            self.params, cfg, feats, torch.as_tensor(counts, device=dev),
            torch.as_tensor(valid, device=dev), obj_sample_t, art,
            canvas_hw=self.canvas_hw, compute_mask=self.compute_mask,
        )
        boxes = dec.pred_boxes.double().cpu().numpy()
        scores = 1.0 / (1.0 + np.exp(-dec.pred_score.double().cpu().numpy()[:, 0]))
        masks = dec.pred_mask.cpu().numpy() if self.compute_mask else None
        mask_hw = dec.mask_hw.cpu().numpy()

        for oi, obj in enumerate(objects):
            w_px, h_px = image_sizes[obj.sample]
            cx, cy, bw, bh = boxes[oi]
            ex = (max(cx - bw / 2, 0.0), max(cy - bh / 2, 0.0), min(bw, 1.0), min(bh, 1.0))
            bbox = (round(ex[0] * w_px), round(ex[1] * h_px), round(ex[2] * w_px), round(ex[3] * h_px))
            mask_rle = None
            if masks is not None:
                gh, gw = int(mask_hw[oi, 0]), int(mask_hw[oi, 1])
                up = upsample_logits(masks[oi, : gh * 4, : gw * 4], w_px, h_px)
                mask_rle = rle_codec.encode((up > 0).astype(np.uint8))  # sigmoid(x) > .5 iff x > 0
            results[obj.sample].objects.append(
                ObjectResult(
                    label=obj.label, score=float(scores[oi]), bbox_xywh_px=bbox,
                    mask_rle=mask_rle, vrt_string=obj.vrt_string,
                )
            )
        return results


def write_predictions(res_path: str, comp_path: str, image_ids: Sequence[Any], results: Sequence[SampleResult]) -> None:
    """Append the JAX package's JSONL rows: one row per sample to `comp_path`
    (image_id, completion) and one per object to `res_path` (image_id,
    score, category, bbox x,y,w,h px, mask RLE)."""
    with open(comp_path, "a") as f:
        for iid, res in zip(image_ids, results):
            f.write(json.dumps({"image_id": iid, "completion": res.completion}) + "\n")
    with open(res_path, "a") as f:
        for iid, res in zip(image_ids, results):
            for o in res.objects:
                row = {"image_id": iid, "score": o.score, "category": o.label, "bbox": list(o.bbox_xywh_px)}
                if o.mask_rle is not None:
                    row["mask"] = {"size": o.mask_rle["size"], "counts": o.mask_rle["counts"]}
                f.write(json.dumps(row) + "\n")


def infer_dataset(
    engine: InferenceEngine,
    dataset: Sequence[Dict],  # rows: {id, image_path, problem}
    output_dir: str,
    batch_size: int = 16,
    datasetname: str = "coco",
    suffix: str = "",
    max_side: Optional[int] = 644,
    log_every: int = 1,
    prompt_bucket: Optional[int] = None,  # pin to keep one prefill shape
    stream: bool = False,  # the continuous-batching serve engine instead of fixed batches
    share_prefix: bool = False,  # with stream: one image prefill per unique image path
    n_slots: int = 16,
    prefill_bucket: int = 4,
    chunk_steps: int = 8,
) -> Tuple[str, str]:
    """Run a dataset through the engine and write the JAX package's JSONL
    files: `{name}_{rank}_pred_results_{suffix}.json` (one row per object:
    image_id, score, category, bbox x,y,w,h px, mask RLE) and
    `..._pred_comp_...json` (image_id, completion). One process (rank 0 of
    1). The next chunk's images are loaded and preprocessed on a worker
    thread while the engine runs the current one."""
    from concurrent.futures import ThreadPoolExecutor

    import PIL.Image

    rank = 0
    res_path = os.path.join(output_dir, f"{datasetname}_{rank}_pred_results_{suffix}.json")
    comp_path = os.path.join(output_dir, f"{datasetname}_{rank}_pred_comp_{suffix}.json")
    os.makedirs(output_dir, exist_ok=True)
    open(res_path, "w").close()
    open(comp_path, "w").close()
    n = len(dataset)
    starts = list(range(0, math.ceil(n / batch_size) * batch_size, batch_size))

    def load_chunk(start):
        rows = [dataset[i] for i in range(start, min(start + batch_size, n))]
        n_real = len(rows)
        rows = rows + [rows[-1]] * (batch_size - n_real)  # one batch shape for every chunk
        images, sizes, paths, cache = [], [], [], {}
        for r in rows:
            path = r["image_path"][0] if isinstance(r["image_path"], list) else r["image_path"]
            if path not in cache:
                img = ensure_min_28(PIL.Image.open(path))
                if max_side and max(img.size) > max_side:
                    img = resize_max_side(img, max_side)
                # boxes stay in the resized image's frame (the reference scale)
                cache[path] = (engine._processed([img])[0], img.size)
            images.append(cache[path][0])
            sizes.append(cache[path][1])
            paths.append(path)
        prompts = [r["problem"] for r in rows]
        prebuilt = engine.build_stream_requests(prompts, images, prompt_bucket=prompt_bucket) if stream and not share_prefix else None
        return rows[:n_real], prompts, images, sizes, paths, prebuilt

    t_wait = t_engine = t_emit = 0.0
    n_done = 0
    t_all = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(load_chunk, starts[0]) if starts else None
        for pos_i, start in enumerate(starts):
            t0 = time.perf_counter()
            rows, prompts, images, sizes, paths, prebuilt = nxt.result()
            t_wait += time.perf_counter() - t0
            if pos_i + 1 < len(starts):  # one chunk of lookahead
                nxt = pool.submit(load_chunk, starts[pos_i + 1])
            n_real = len(rows)
            if (start // batch_size) % log_every == 0:
                print(f"Processing {start}... | Total: {n}")
            t0 = time.perf_counter()
            if stream:
                results = engine.run_stream(
                    prompts, images, image_sizes=sizes, n_slots=n_slots, prefill_bucket=prefill_bucket,
                    chunk_steps=chunk_steps, prompt_bucket=prompt_bucket, share_prefix=share_prefix,
                    suffix_bucket=128 if share_prefix else None, prefix_keys=paths if share_prefix else None,
                    prebuilt=prebuilt,
                )[:n_real]
            else:
                results = engine.run_batch(prompts, images, image_sizes=sizes, prompt_bucket=prompt_bucket)[:n_real]
            t_engine += time.perf_counter() - t0
            n_done += n_real
            t0 = time.perf_counter()
            write_predictions(res_path, comp_path, [r["id"] for r in rows], results)
            t_emit += time.perf_counter() - t0
    wall = time.perf_counter() - t_all
    if n_done:
        stats = {
            "samples": n_done, "wall_s": round(wall, 2), "samples_per_sec": round(n_done / wall, 3),
            "host_prefetch_wait_s": round(t_wait, 2), "engine_s": round(t_engine, 2),
            "emit_jsonl_s": round(t_emit, 2),
        }
        split = engine.pop_stream_stats() if stream else None
        if split:
            split.pop("spans", None)
            r2 = lambda v: round(v, 2) if isinstance(v, float) else v
            stats["stream_split"] = {
                k: ({n: r2(x) for n, x in v.items()} if isinstance(v, dict) else r2(v)) for k, v in split.items()
            }
        print(json.dumps({"infer_dataset_stats": stats}))
    return res_path, comp_path
