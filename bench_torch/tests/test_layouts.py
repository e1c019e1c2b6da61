"""The text stack's weight layout is a file of its own (`layouts/<layout>.py`,
named by the configuration's `layout` key), and the program's config is
filled from the configuration's keys by name.

`layouts_recorded.json` holds what the harness gave before the layout
became a file of its own: the seeded tiny trees (each leaf's path, shape
and dtype, in order, and a SHA-256 of their bytes), the leaves of `spec()`
at the published configurations, `counts.query_flops` at three queries,
and `port_config(...).to_json()`. The harness has to give the same, to
the bit. A stand-in layout in a file of its own, with a leaf more, shows
that another text stack needs no edit to a file that is here.

    python -m pytest bench_torch/tests/test_layouts.py -q
"""

import hashlib
import json
import os
import sys

import pytest
import torch

import bench_torch.layouts
from bench_torch.layouts import qwen25vl
from bench_torch.lib import counts, layout
from bench_torch.lib.model import port_config
from bench_torch.tests.tiny import tiny_model

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUBLISHED = ("padt3b", "padt7b_int8")


def _load(*path):
    with open(os.path.join(HERE, *path)) as f:
        return json.load(f)


RECORDED = _load("tests", "layouts_recorded.json")


def _published(name):
    return _load("configs", name + ".json")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_seeded_tiny_tree(form):
    weights = layout.make_weights(tiny_model(int8=form == "int8"), RECORDED["seed"], "cpu")
    h = hashlib.sha256()
    leaves = []
    for path, t in _leaves(weights):
        leaves.append([path, list(t.shape), str(t.dtype).replace("torch.", "")])
        h.update(t.contiguous().view(torch.uint8).reshape(-1).numpy().tobytes())
    assert leaves == RECORDED["tiny"][form]["leaves"]
    assert h.hexdigest() == RECORDED["tiny"][form]["sha256"]


@pytest.mark.parametrize("name", PUBLISHED)
def test_published_spec(name):
    got = [[p, list(shape), kind] for p, (shape, kind) in _leaves(layout.spec(_published(name)))]
    assert got == RECORDED["spec"][name]


@pytest.mark.parametrize("name", PUBLISHED)
def test_query_flops(name):
    model = _published(name)
    for grid, prompt, generated, flops in RECORDED["query_flops"][name]:
        assert counts.query_flops(model, grid, prompt, generated) == flops


@pytest.mark.parametrize("name", PUBLISHED + ("tiny",))
def test_port_config(name):
    model = tiny_model() if name == "tiny" else _published(name)
    assert json.loads(port_config(model).to_json()) == RECORDED["port_config"][name]


STANDIN = '''
from bench_torch.layouts import qwen25vl


def text_spec(model):
    text = qwen25vl.text_spec(model)
    text["layers"]["router_w"] = ((model["num_hidden_layers"], model["hidden_size"], model["num_experts"]), "w")
    return text


def text_flops(model, prompt_tokens, generated):
    return 2 * qwen25vl.text_flops(model, prompt_tokens, generated)
'''


def test_standin_layout_from_a_file_of_its_own(tmp_path, monkeypatch):
    """A configuration naming a layout that lives in a new file gets that
    file's text leaves from `make_weights` and its text operations in
    `query_flops`."""
    name = "standin_router"
    (tmp_path / f"{name}.py").write_text(STANDIN)
    monkeypatch.setattr(bench_torch.layouts, "__path__", [*bench_torch.layouts.__path__, str(tmp_path)])
    model = dict(tiny_model(), layout=name, num_experts=8)
    try:
        spec = dict(_leaves(layout.spec(model)))
        weights = dict(_leaves(layout.make_weights(model, RECORDED["seed"], "cpu")))
        query = (1, 16, 16), 90, 12
        extra = counts.query_flops(model, *query) - counts.query_flops(tiny_model(), *query)
    finally:
        sys.modules.pop(f"bench_torch.layouts.{name}", None)
    assert spec["text/layers/router_w"] == ((4, 96, 8), "w")
    assert set(weights) == set(spec)
    assert all(tuple(weights[p].shape) == shape for p, (shape, _) in spec.items())
    assert weights["text/layers/router_w"].float().std() > 0
    assert extra == qwen25vl.text_flops(model, *query[1:])


def test_unknown_layout_exits():
    model = dict(_published("padt3b"), layout="no_such_stack")
    with pytest.raises(SystemExit, match="no_such_stack.py"):
        layout.spec(model)
    with pytest.raises(SystemExit, match="no_such_stack.py"):
        counts.query_flops(model, (1, 46, 46), 640, 20)


def test_attention_bias_reaches_the_program():
    model = _published("padt3b")
    cfg = port_config(dict(model, attention_bias=False))
    assert cfg.text.attention_bias is False
    assert cfg.replace(text=port_config(model).text) == port_config(model)
