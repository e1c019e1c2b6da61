"""The sparse-expert text stack (Keye-VL-2.0's Qwen3-MoE block) on the CPU
at a tiny size, against the benchmark's plain float32 reference
(`bench_torch/references/padt_keye_moe.py`, imported from there), and H11
against its plain twin on the card.

Tiny MoE: hidden 96, 4 layers, 4 q / 2 kv heads of 32, 16 experts of width
32, 8 a token (`norm_topk_prob`), per-head q / k norms, no attention bias.
Weights are the program's seeded init with the matrices scaled by 5 (so the
layers weigh against the embeddings) and random q / k norm weights.

Card cases (`cuda` marker; they skip here): H11 against the twin at
Keye's widths at a decode (32 tokens, 256 choices) and a prefill (2560
tokens, 20480 choices) shape, and a graphed Keye decode step against an
eager one, bit for bit. Run them on the card with
`python -m pytest tests/test_torch_moe.py -q`.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from padt_tpu_torch import padt_tiny
from padt_tpu_torch.config import PaDTConfig, TextConfig
from padt_tpu_torch.models import language as L
from padt_tpu_torch.models import padt as P
from padt_tpu_torch.ops import moe as M
from padt_tpu_torch.ops.norms import rms_norm

REF = importlib.import_module("bench_torch.references.padt_keye_moe")
QWEN = importlib.import_module("bench_torch.references.padt_qwen25vl")

# float32 on both sides, sums in another order: 1e-5 of the largest value
# (read: 6e-7)
F32_TOL = 1e-5
# the int8 KV pool: per-token, per-head scales leave each K / V value within
# half a quantum (0.4 % of its row's largest value); read through the 4
# layers: 0.45 % of the largest logit, so 1.5e-2 leaves three times that
INT8_KV_TOL = 1.5e-2


def moe_cfg(**kw) -> PaDTConfig:
    cfg = padt_tiny()
    text = dataclasses.replace(cfg.text, num_experts=16, num_experts_per_tok=8, moe_intermediate_size=32,
                               norm_topk_prob=True, qk_norm=True, attention_bias=False, sa_topk=2048, **kw)
    return cfg.replace(text=text)


def moe_text(tc: TextConfig, seed: int = 0, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    p = L.init_text_params(tc, g, "cpu", torch.float32)
    lay = p["layers"]
    for k, v in lay.items():
        if v.dim() >= 3:
            lay[k] = v * 5.0
    for k in ("q_norm_w", "k_norm_w"):
        lay[k] = 1.0 + 0.3 * torch.randn(lay[k].shape, generator=g)
    return {k: (v.to(device, dtype) if torch.is_tensor(v) else {n: t.to(device, dtype) for n, t in v.items()})
            for k, v in p.items()}


def ref_stack(text, tc: TextConfig, embeds: torch.Tensor, pos: torch.Tensor):
    """The reference's text layers over one sequence (n, d) at positions
    (3, n): post-norm hidden and each layer's expert ids."""
    packed = P.pack_inference_params({"text": text})["text"]
    cfg = dataclasses.asdict(tc)
    cos, sin = QWEN.text_cos_sin(pos, tc.head_dim, tc.mrope_section, tc.rope_theta)
    prec = REF.Precision("fp32")
    x, ids = embeds.float(), []
    for li in range(tc.num_hidden_layers):
        lp = {k: v[li].float() for k, v in packed["layers"].items()}
        h = x + REF._attention(x, lp, cfg, cos, sin, prec)
        hn = QWEN.rms_norm(h, lp["post_ln_w"], tc.rms_norm_eps)
        ids.append(REF.routing(hn, lp["router_w"], tc.num_experts_per_tok, tc.norm_topk_prob, prec)[1])
        x = h + REF.moe(hn, lp, cfg, prec)
    return QWEN.rms_norm(x, packed["final_ln_w"].float(), tc.rms_norm_eps), ids


def _inputs(tc, b=2, l=20, pad=(0, 5), seed=1):
    """Embeddings, validity (row i left-padded by pad[i]) and positions
    counting real tokens from 0."""
    r = np.random.RandomState(seed)
    embeds = torch.tensor(r.randn(b, l, tc.hidden_size).astype(np.float32))
    valid = torch.ones(b, l, dtype=torch.bool)
    for i, n in enumerate(pad):
        valid[i, :n] = False
    pos = (valid.long().cumsum(1) - 1).clamp(min=0)
    return embeds, valid, pos[None].expand(3, b, l).contiguous()


def _logits(hidden, text):
    return hidden.float() @ text.get("lm_head", text["embed"]).float().T


def _close(a, b, tol):
    a, b = a.float(), b.float()
    assert (a - b).abs().max().item() <= tol * b.abs().max().item(), ((a - b).abs().max().item(), b.abs().max().item())


def test_text_forward_logits_match_the_reference():
    tc = moe_cfg().text
    text = moe_text(tc)
    embeds, valid, pos = _inputs(tc)
    hidden, _ = L.text_forward(text, tc, embeds, pos, valid)
    for i in range(embeds.shape[0]):
        real = valid[i]
        ref, _ = ref_stack(text, tc, embeds[i][real], pos[:, i][:, real])
        _close(_logits(hidden[i][real], text), _logits(ref, text), F32_TOL)


def test_prefill_then_decode_through_the_int8_pool():
    """The serve form: packed weights, int8 prefill, then four decode steps
    over the int8 KV pool (H4's and H6's twins), against the reference's
    full forward over the prompt and the new tokens."""
    tc = moe_cfg().text
    text = moe_text(tc)
    packed = P.pack_inference_params({"text": text})["text"]
    embeds, valid, pos = _inputs(tc, l=24)
    b, l = valid.shape
    n_new, p0 = 4, 16
    h, cache = L.prefill(packed, tc, embeds[:, :p0], pos[:, :, :p0], valid[:, :p0], 32, kv_dtype="int8")
    outs = [h[:, -1]]
    for s in range(p0, p0 + n_new - 1):
        h, cache = L.decode_step(packed, tc, embeds[:, s : s + 1], pos[:, :, s : s + 1], cache)
        outs.append(h[:, 0])
    got = torch.stack(outs, 1)  # hidden at positions p0-1 .. p0+n_new-2
    for i in range(b):
        real = valid[i, : p0 + n_new - 1]
        ref, _ = ref_stack(text, tc, embeds[i, : p0 + n_new - 1][real], pos[:, i, : p0 + n_new - 1][:, real])
        _close(_logits(got[i], text), _logits(ref[-n_new:], text), INT8_KV_TOL)


def test_routing_matches_the_reference():
    tc = moe_cfg().text
    r = torch.Generator().manual_seed(3)
    xn = torch.randn(64, tc.hidden_size, generator=r)
    router = 0.5 * torch.randn(tc.hidden_size, tc.num_experts, generator=r)
    for norm in (True, False):
        w, ids = M.route(xn, router, tc.num_experts_per_tok, norm)
        rw, rids = REF.routing(xn, router, tc.num_experts_per_tok, norm, REF.Precision("fp32"))
        assert torch.equal(ids, rids)
        torch.testing.assert_close(w, rw, rtol=1e-6, atol=1e-7)
        if norm:
            torch.testing.assert_close(w.sum(-1), torch.ones(64), rtol=1e-6, atol=1e-6)
    g = M.group(w, ids, tc.num_experts)
    # the choices in expert order, each expert's in token order (a stable sort)
    order = torch.sort(ids.reshape(-1), stable=True).indices
    assert torch.equal(g.dst.long(), order) and torch.equal(g.src.long(), order // tc.num_experts_per_tok)
    assert torch.equal(g.ends.long(), torch.bincount(ids.reshape(-1), minlength=tc.num_experts).cumsum(0))
    assert torch.equal(g.scale, w.reshape(-1)[order])


def test_prefill_counters_match_the_reference_routing():
    """`tally` counts the choices of real tokens (the rows `real` marks) and
    the (layer, expert) pairs they hit, as the reference routes them."""
    tc = moe_cfg().text
    text = moe_text(tc)
    embeds, valid, pos = _inputs(tc, b=3, pad=(0, 5, 9))
    real = valid.clone()
    real[2] = False  # a bucket's padding request
    tally = M.Tally(torch.zeros(tc.num_hidden_layers, tc.num_experts, dtype=torch.int32),
                    torch.zeros(2, dtype=torch.int64))
    L.prefill(P.pack_inference_params({"text": text})["text"], tc, embeds, pos, valid, 32, kv_dtype="int8",
              real=real, tally=tally)
    hit, rows = 0, 0
    per_row = [ref_stack(text, tc, embeds[i][valid[i]], pos[:, i][:, valid[i]])[1] for i in range(2)]
    for li in range(tc.num_hidden_layers):
        ids = torch.cat([per_row[i][li] for i in range(2)])
        rows += ids.numel()
        hit += ids.unique().numel()
    assert tally.totals.tolist() == [rows, hit] and not tally.counts.any()  # folded and cleared
    assert rows == int(real.sum()) * tc.num_experts_per_tok * tc.num_hidden_layers


def test_no_attention_bias_and_qk_norm():
    """attention_bias=False: no bias leaf, and none is added even where a
    tree holds one; qk_norm: each q and k head is RMS-normalised with its
    weight before rope (positions 0: rope is the identity there)."""
    tc = moe_cfg().text
    text = moe_text(tc)
    layers = text["layers"]
    assert not any(k.endswith("_b") for k in layers) and {"q_norm_w", "k_norm_w"} <= set(layers)
    packed = P.pack_inference_params({"text": text})["text"]
    assert "qkv_b" not in packed["layers"] and "qkv_w" in packed["layers"]
    lp = {k: v[0] for k, v in packed["layers"].items()}
    x = torch.randn(1, 3, tc.hidden_size)
    zeros = torch.zeros(3, 1, 3, dtype=torch.long)
    from padt_tpu_torch.ops.rope import mrope_cos_sin

    cos, sin = mrope_cos_sin(zeros, tc.head_dim, tc.mrope_section, tc.rope_theta)
    q, k, v = L._qkv_rot(x, lp, tc, cos, sin)
    h, hkv, hd = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    qkv = x @ lp["qkv_w"]
    heads = lambda a, b: qkv[..., a * hd : b * hd].unflatten(-1, (b - a, hd))
    torch.testing.assert_close(q, rms_norm(heads(0, h), lp["q_norm_w"], tc.rms_norm_eps))
    torch.testing.assert_close(k, rms_norm(heads(h, h + hkv), lp["k_norm_w"], tc.rms_norm_eps))
    torch.testing.assert_close(v, qkv[..., (h + hkv) * hd :].unflatten(-1, (hkv, hd)))
    biased = dict(lp, qkv_b=torch.ones(qkv.shape[-1]))
    assert torch.equal(L._qkv_rot(x, biased, tc, cos, sin)[2], v)


def test_config_json_round_trip():
    cfg = moe_cfg()
    assert PaDTConfig.from_json(cfg.to_json()) == cfg
    text = json.loads(cfg.to_json())["text"]
    assert [text[k] for k in ("num_experts", "moe_intermediate_size", "qk_norm", "sa_topk")] == [16, 32, True, 2048]
    dense = json.loads(padt_tiny().to_json())["text"]
    assert not {"num_experts", "num_experts_per_tok", "moe_intermediate_size", "norm_topk_prob", "qk_norm",
                "sa_topk"} & set(dense)
    assert PaDTConfig.from_json(padt_tiny().to_json()) == padt_tiny()


def test_engine_refuses_capacity_past_the_indexer():
    from padt_tpu_torch.serve import ServeEngine

    cfg = moe_cfg().replace(text=dataclasses.replace(moe_cfg().text, sa_topk=128))
    params = P.init_padt_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    with pytest.raises(ValueError, match="indexer is not implemented"):
        ServeEngine(params, cfg, n_slots=2, max_new_tokens=8, prompt_len=128, patch_bucket=128)
    ServeEngine(params, cfg, n_slots=2, max_new_tokens=8, prompt_len=120, patch_bucket=128)  # capacity 128 fits


# the dense tree's leaves as they were before the MoE fields existed
DENSE_LEAVES = ["down_w", "gate_w", "input_ln_w", "k_b", "k_w", "o_w", "post_ln_w", "q_b", "q_w", "up_w", "v_b", "v_w"]


def test_dense_tree_and_outputs_unchanged():
    """padt_tiny's tree keeps its leaves, and its forward through `_mlp`
    with the new defaults is the dense SwiGLU MLP, exactly."""
    cfg = padt_tiny()
    assert cfg.text.num_experts == 0 and cfg.text.attention_bias and not cfg.text.qk_norm
    tp = L.init_text_params(cfg.text, torch.Generator().manual_seed(0), "cpu", torch.float32)
    assert sorted(tp["layers"]) == DENSE_LEAVES
    packed = P.pack_inference_params({"text": tp})["text"]
    assert sorted(packed["layers"]) == ["down_w", "gateup_w", "input_ln_w", "o_w", "post_ln_w", "qkv_b", "qkv_w"]
    lp = {k: v[1] for k, v in tp["layers"].items()}
    x = torch.randn(2, 5, cfg.text.hidden_size)
    want = (torch.nn.functional.silu(x @ lp["gate_w"]) * (x @ lp["up_w"])) @ lp["down_w"]
    assert torch.equal(L._mlp(x, lp, cfg.text), want) and torch.equal(L._mlp(x, lp), want)
    embeds, valid, pos = _inputs(cfg.text)
    tally = M.Tally(torch.zeros(cfg.text.num_hidden_layers, 0, dtype=torch.int32), torch.zeros(2, dtype=torch.int64))
    a = L.prefill(packed, cfg.text, embeds, pos, valid, 32, kv_dtype="int8")[0]
    b = L.prefill(packed, cfg.text, embeds, pos, valid, 32, kv_dtype="int8", real=valid, tally=tally)[0]
    assert torch.equal(a, b) and tally.totals.tolist() == [0, 0]  # a dense stack counts no experts


def _proc_requests(cfg, budgets):
    from padt_tpu_torch.preprocess.vision_process import ProcessedImage
    from padt_tpu_torch.serve import Request
    from padt_tpu_torch.utils.mock_tokenizer import make_tiny_tokenizer
    from padt_tpu_torch.vrt.processor import VisionTextProcessor

    proc = VisionTextProcessor(make_tiny_tokenizer(cfg), cfg, seq_bucket=32, patch_bucket=128)
    proc.prepare(cfg.text.vocab_size)
    grid = (1, 8, 12)
    img = lambda s: ProcessedImage(None, grid, np.random.RandomState(s).randint(0, 256, (96, 588)).astype(np.uint8))
    prompts = ["detect the cat", "find a dog", "locate the car", "what is here"]
    reqs = []
    for i, n in enumerate(budgets):
        b = proc.build_batch([prompts[i % 4]], [img(i)], prompt_bucket=128, patch_bucket=128)
        reqs.append(Request(batch=b.data, rope_delta=int(b.rope_deltas[0]), max_new_tokens=n, uid=i))
    return reqs


def _moe_model(device="cpu", dtype=torch.float32):
    cfg = moe_cfg()
    params = P.init_padt_params(cfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
    params["text"] = moe_text(cfg.text, seed=2)
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) else t.to(device, dtype)
    return cfg, to(params)


def test_engine_counts_expert_rows_and_hits():
    """Through the serve engine: decode choices are k x layers per
    generated token after each request's first (a step's forward runs
    for the slots still generating), prefill choices k x layers per real
    prompt token (a bucket's padding request is not counted), and a
    (layer, expert) pair counts at most once a forward."""
    from padt_tpu_torch.serve import ServeEngine

    cfg, params = _moe_model()
    budgets = [3, 6, 2, 5, 4]
    reqs = _proc_requests(cfg, budgets)
    eng = ServeEngine(params, cfg, n_slots=4, max_new_tokens=8, prompt_len=128, prefill_bucket=2,
                      prefill_bucket_small=2, chunk_steps=3, patch_bucket=128)
    res, st = eng.run(reqs)
    kl = cfg.text.num_experts_per_tok * cfg.text.num_hidden_layers
    prompt = sum(int(np.asarray(q.batch["attention_mask"]).sum()) for q in reqs)
    assert st.prefill_expert_rows == prompt * kl == st.prompt_tokens * kl
    assert st.decode_expert_rows == sum(c.n_gen - 1 for c in res) * kl
    pairs = cfg.text.num_experts * cfg.text.num_hidden_layers
    assert 0 < st.decode_experts_hit <= pairs * st.decode_steps
    assert 0 < st.prefill_experts_hit <= pairs * st.admissions
    assert st.moe_forwards == st.decode_steps + st.admissions


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (H11 is a CUDA kernel with no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [32, 2560], ids=["decode", "prefill"])
def test_h11_matches_its_twin(dev, tokens):
    """H11 against its plain twin at Keye's widths (d 2048, 128 experts of
    768, 8 a token): both sum bf16 products in float32 and round once to
    bf16, in another order, so each output lies within 1e-2 of the largest
    (a bf16 rounding is 2^-8 of a value)."""
    from padt_tpu_torch.ops import cuda_moe

    d, e, fe, k = 2048, 128, 768, 8
    g = torch.Generator(device=dev).manual_seed(tokens)
    x = torch.randn(tokens, d, generator=g, device=dev).to(torch.bfloat16)
    gate_up = (0.02 * torch.randn(e, d, 2 * fe, generator=g, device=dev)).to(torch.bfloat16)
    down = (0.02 * torch.randn(e, fe, d, generator=g, device=dev)).to(torch.bfloat16)
    router = 0.02 * torch.randn(d, e, generator=g, device=dev)
    w, ids = M.route(x, router, k, True)
    grp = M.group(w, ids, e)
    n0 = cuda_moe.launch_counts["expert_matmul"]
    h = cuda_moe.expert_matmul(x, gate_up, grp, "gateup")
    y = cuda_moe.expert_matmul(h, down, grp, "down")
    assert cuda_moe.launch_counts["expert_matmul"] - n0 == 2
    h_ref = M.expert_matmul_plain(x, gate_up, grp, "gateup")
    _close(h, h_ref, 1e-2)
    _close(y, M.expert_matmul_plain(h, down, grp, "down"), 1e-2)
    out = M.moe_mlp(x, router, gate_up, down, k, True)
    ref = (M.expert_matmul_plain(h_ref, down, grp, "down").view(tokens, k, d).float().sum(1))
    _close(out, ref, 2e-2)  # two bf16 roundings more (h, then each row) than the twin's sum
    assert torch.equal(out, M.moe_mlp(x, router, gate_up, down, k, True))  # deterministic


@pytest.mark.cuda
def test_graphed_keye_step_equals_eager_bit_for_bit(dev):
    """A decode step of the tiny MoE model in bf16 on the card, replayed
    from its CUDA graph, gives the eager step's state to the bit: tokens,
    hidden, the KV rows, the MoE tally."""
    from padt_tpu_torch.serve import ServeEngine
    from padt_tpu_torch.serve import engine as S
    from padt_tpu_torch.utils.profiling import Recorder

    cfg, params = _moe_model(dev, torch.bfloat16)
    reqs = _proc_requests(cfg, [12, 12, 12, 12])
    eng = ServeEngine(params, cfg, n_slots=4, max_new_tokens=12, prompt_len=128, prefill_bucket=4, chunk_steps=2,
                      patch_bucket=128)
    eng._decode_graphs.limit = 0
    ctx = eng.start_run(reqs)
    eng._refill(ctx)
    eng._dispatch_chunk(ctx)  # two eager steps
    torch.cuda.synchronize()
    st = eng.state
    names = [f.name for f in dataclasses.fields(st) if torch.is_tensor(getattr(st, f.name))]
    before = {n: getattr(st, n).clone() for n in names}
    step = lambda rec: S._plain_step(eng.params, cfg, st, eng.sampling, rec=rec)
    step(Recorder())
    eager = {n: getattr(st, n).clone() for n in names}
    for n in names:
        getattr(st, n).copy_(before[n])
    graphs = S.Graphs(1, dev, "decode.capture", "decode.step")
    graphs.capture("step", step)
    graphs.replay("step")
    torch.cuda.synchronize()
    for n in names:
        assert torch.equal(getattr(st, n), eager[n]), n
    assert eager["moe_tally"][0].item() > before["moe_tally"][0].item()
