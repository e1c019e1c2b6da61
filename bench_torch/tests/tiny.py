"""A tiny configuration and tiny traffic (the program's `padt_tiny`
shapes), for running the harness end to end on the CPU."""

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_model(name: str = "padt3b", int8: bool = False, vocab_size: int = 1024):
    m = json.load(open(os.path.join(HERE, "configs", name + ".json")))
    v = vocab_size
    m.update(
        hidden_size=96, intermediate_size=160, num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, vocab_size=v, mrope_section=[4, 6, 6], image_token_id=v - 10, video_token_id=v - 9,
        vision_start_token_id=v - 12, eos_token_id=v - 1, pad_token_id=v - 2, max_image_patches=256,
        max_vrt_per_object=8, max_objects=8, init_std=0.1, text_layer_weights="int8" if int8 else "bf16",
    )
    m["special_tokens"] = {"<|im_start|>": 256, "<|im_end|>": v - 1, "<|vision_start|>": v - 12,
                           "<|vision_end|>": v - 11, "<|image_pad|>": v - 10}
    m["vision_config"] = dict(m["vision_config"], depth=4, hidden_size=64, intermediate_size=128, num_heads=4,
                              out_hidden_size=96, fullatt_block_indexes=[1, 3])
    m["decoder_config"] = dict(m["decoder_config"], hidden_size=64, intermediate_size=128, num_heads=4)
    return m


def tiny_traffic():
    t = copy.deepcopy(json.load(open(os.path.join(HERE, "traffic", "refcoco_stream.json"))))
    t.update(block=8, image_sizes=[[[200, 150], 3], [[150, 200], 2], [[224, 224], 1], [[300, 200], 1], [[20, 60], 1]],
             output_lengths=[[3, 2], [4, 2], [5, 2], [8, 2]], expression_words=[[1, 2], [3, 2], [5, 2], [8, 2]],
             max_side=224, prompt_bucket=128, patch_bucket=256, check_requests=4,
             n_slots=4, prefill_bucket=2, chunk_steps=2, max_new_tokens=16)
    return t


# the program expands pixels in bf16 even in float32, so near ties can flip at the tiny widths
LIMITS = {"max_logit_gap": {"limit": 0.1}, "tokens_checked": {"limit": 8}, "inputs_differ": {"limit": 0}}
