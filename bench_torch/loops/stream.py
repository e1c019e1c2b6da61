"""Closed loop of chunks through `InferenceEngine.run_stream`, as
`infer_dataset(stream=True)` drives it (a copy of its chunk loop,
`padt_tpu_torch/eval/harness.py::infer_dataset`): the next chunk's images
are resized and preprocessed, and its requests built with
`build_stream_requests`, on one worker thread while the engine runs the
current chunk; the requests go in as `prebuilt`. The window is whole
chunks: it ends with the first chunk that finishes `--seconds` or more
after the window began. With the trace on, the profiler covers one
chunk more, run once the window has closed: the same work as each chunk
of the window (one block of the traffic), while the window stays as an
untraced run's (the profiler slows the host in the chunk it traces, and
in chunks after it).

A loop module gives the harness three calls: `build` (the program's
system over the seeded weights), `run` (warm-up and window into the
record) and `check` (`correct`, once the system is freed).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from ..lib import check as served_check, traffic as traffic_gen
from ..lib.record import Record, Served
from ..lib.trace import DeviceTrace


def served_len(row: np.ndarray, budget: int, eos: int) -> int:
    """Tokens a query was served: up to and with its EOS, else its budget."""
    hit = np.flatnonzero(row[:budget] == eos)
    return int(hit[0]) + 1 if hit.size else budget


def capture_tokens(eng, spans) -> List[np.ndarray]:
    """The list into which every call of the engine's postprocess puts the
    token rows it was handed: the served tokens, read where the program
    hands them on (it returns only their decoded text)."""
    sink: List[np.ndarray] = []
    post = eng._postprocess

    def capture(tokens, *a, **k):
        sink.append(np.array(tokens))
        return post(tokens, *a, **k)

    eng._postprocess = capture
    spans.wrap(eng, "_postprocess", "postprocess")
    return sink


def client_image(q, max_side: int):
    """A query's image as `infer_dataset` and `tools/demo.py` hand it on: at
    least 28 px a side, the longer side resized to `max_side`."""
    import PIL.Image

    from padt_tpu_torch.preprocess.vision_process import ensure_min_28, resize_max_side

    img = ensure_min_28(PIL.Image.fromarray(q.pixels()))
    return resize_max_side(img, max_side) if max(img.size) > max_side else img


def prepare(eng, traffic: Dict, qs) -> Dict:
    """Host work of one chunk: seeded images resized to the max side,
    preprocessed, and the stream requests built."""
    from padt_tpu_torch.preprocess.vision_process import process_image

    proc = eng.processor
    images, sizes = [], []
    for q in qs:
        img = client_image(q, traffic["max_side"])
        images.append(process_image(img, proc.min_pixels, proc.max_pixels, u8_rows=True))
        sizes.append(img.size)
    prompts = [q.prompt for q in qs]
    reqs, bucket = eng.build_stream_requests(
        prompts, images, patch_bucket=traffic["patch_bucket"], prompt_bucket=traffic["prompt_bucket"],
    )
    for r, q in zip(reqs, qs):
        r.max_new_tokens = q.max_new_tokens
    return {"qs": qs, "prompts": prompts, "images": images, "sizes": sizes, "prebuilt": (reqs, bucket)}


def _run_chunk(eng, traffic: Dict, c: Dict, sink: List):
    sink.clear()
    eng.run_stream(
        c["prompts"], c["images"], image_sizes=c["sizes"], n_slots=traffic["n_slots"],
        prefill_bucket=traffic["prefill_bucket"], chunk_steps=traffic["chunk_steps"],
        prompt_bucket=traffic["prompt_bucket"], patch_bucket=traffic["patch_bucket"], prebuilt=c["prebuilt"],
    )
    return sink[0]


def build(weights, model: Dict, traffic: Dict, device):
    """The program's `InferenceEngine` over the seeded weights."""
    from ..lib.model import engine, port_config, processor

    cfg = port_config(model)
    return engine(weights, cfg, processor(cfg), traffic["max_new_tokens"])


def _record(rec: Record, c: Dict, tokens: np.ndarray, stats, wall: float, wait: float, traced: bool, eos: int) -> None:
    rec.chunk_stats.append(stats)
    rec.chunk_wall_s.append(wall)
    rec.chunk_wait_s.append(wait)
    rec.chunk_traced.append(traced)
    reqs = c["prebuilt"][0]
    for i, q in enumerate(c["qs"]):
        row = tokens[i]
        rec.served.append(Served(
            index=q.index, grid=tuple(int(v) for v in c["images"][i].grid_thw),
            prompt_tokens=int(np.asarray(reqs[i].batch["attention_mask"]).sum()),
            tokens=row[: served_len(row, q.max_new_tokens, eos)].copy(), traced=traced,
        ))
    rec.attempted += len(c["qs"])


def run(eng, rec: Record, seed: int, seconds: float, trace: bool, warm: bool, log=print) -> None:
    """Warm up on one chunk (with `warm`), then run the window into `rec`,
    and with `trace` one chunk more under the profiler. The window's first
    chunk is prepared while the warm-up runs, so the window starts in the
    steady state of the loop."""
    t = rec.traffic
    queries = traffic_gen.queries(t, seed)
    n = t["block"]
    eos = eng.cfg.eos_token_id
    spans = rec.spans
    sink = capture_tokens(eng, spans)
    take = lambda: [next(queries) for _ in range(n)]
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        warm_chunk = prepare(eng, t, take()) if warm else None
        nxt = pool.submit(prepare, eng, t, take())
        if warm:
            _run_chunk(eng, t, warm_chunk, sink)
            eng.pop_stream_stats()
        rec.window_start = time.time()
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            t_chunk = time.perf_counter()
            with spans.span("prefetch_wait"):
                c = nxt.result()
                wait = time.perf_counter() - t_chunk
            nxt = pool.submit(prepare, eng, t, take())
            with spans.span("run_stream"):
                tokens = _run_chunk(eng, t, c, sink)
            _record(rec, c, tokens, eng.pop_stream_stats(), time.perf_counter() - t_chunk, wait, False, eos)
        rec.window_s = time.perf_counter() - t_start
        if trace:
            c = nxt.result()
            _wrap_engine(eng, spans)
            rec.trace = DeviceTrace()
            rec.trace.start()
            t_chunk = time.perf_counter()
            with spans.span("run_stream"):
                tokens = _run_chunk(eng, t, c, sink)
            stats, wall = eng.pop_stream_stats(), time.perf_counter() - t_chunk
            rec.trace.stop()
            _record(rec, c, tokens, stats, wall, 0.0, True, eos)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    rec.failed = sum(1 for s in rec.served if len(s.tokens) == 0)
    log(f"[window] chunk walls {[round(x, 4) for x in rec.chunk_wall_s]} s, "
        f"waits {[round(x, 4) for x in rec.chunk_wait_s]} s, traced {rec.chunk_traced}")


def program_input(model: Dict, traffic: Dict):
    """query -> the (ids, uint8 patch rows, grid) the program builds from
    it, as the window's chunks build them: the real prompt tokens of its
    batch, and the patch rows that batch ships to the device."""
    from padt_tpu_torch.preprocess.vision_process import process_image

    from ..lib.model import port_config, processor

    proc = processor(port_config(model))

    def build_one(q):
        pim = process_image(client_image(q, traffic["max_side"]), proc.min_pixels, proc.max_pixels, u8_rows=True)
        b = proc.build_batch([q.prompt], [pim], prompt_bucket=traffic["prompt_bucket"],
                             patch_bucket=traffic["patch_bucket"]).data
        mask = np.asarray(b["attention_mask"][0]).astype(bool)
        return np.asarray(b["input_ids"][0])[mask], b["pixel_patches_u8"][0][: pim.num_patches], tuple(pim.grid_thw)

    return build_one


def check(rec: Record, weights, model: Dict, traffic: Dict, seed: int, device, limits: Dict, control=None):
    """The served tokens of a sample of the window against the reference
    (`lib/check.py`); the reference's inputs are held against the
    program's."""
    return served_check.check(rec, weights, model, traffic, seed, device, limits, control=control,
                              program_input=program_input(model, traffic))


def _wrap_engine(eng, spans) -> None:
    """Spans around the serve engine's admission, decode-chunk dispatch and
    flag readback, for naming the device's idle gaps."""
    for se in eng._serve_cache.values():
        if getattr(se, "_bench_spans", False):
            continue
        spans.wrap(se, "_admit", "admission")
        spans.wrap(se, "_dispatch_chunk", "decode_chunk")
        spans.wrap(se, "_sync_harvest", "flag_readback")
        se._bench_spans = True
