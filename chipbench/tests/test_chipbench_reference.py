"""Each plain reference against the program's CPU path at a reduced size
in float32, on weights the harness draws: the same logits at every
position. (The test imports both; the reference imports nothing of the
program.)"""
import json

import pytest
import torch

from harness import check, weights
from harness.manifest import load_module
from harness.serve import check_layout, port_config

from conftest import BENCH, TINY


def setup(family, **over):
    src = "olmo-1b" if family == "dense" else "mamba2-1.3b"
    cfg = json.loads((BENCH / "configs" / f"{src}.json").read_text())
    cfg.update(TINY[family], **over)
    ref = load_module(BENCH / "reference" / f"{cfg['reference']}.py",
                      f"t_ref_{cfg['reference']}")
    from repro_torch.models.registry import build_model
    api = build_model(port_config(cfg), "cpu")
    layout = ref.layout(cfg)
    check_layout(layout, api.plan)
    w = weights.make(layout, 1234, "cpu", torch.float32)
    return cfg, ref, api, w


@pytest.mark.parametrize("family,over", [
    ("dense", {}), ("dense", {"num_kv_heads": 1}),
    ("ssm", {}), ("ssm", {"ssm_chunk": 16})])
def test_reference_equals_the_programs_cpu_forward(family, over):
    cfg, ref, api, w = setup(family, **over)
    g = torch.Generator().manual_seed(7)
    # longer than one chunk of the reference's SSD (256) and the port's
    tokens = torch.randint(1, cfg["vocab_size"], (300,), generator=g)
    want = ref.logits(w, cfg, tokens)
    got, _ = api.forward(api.prepare(w), {"tokens": tokens[None]})
    got = got[0, :, :cfg["vocab_size"]].float()
    assert want.shape == got.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * max(1.0, scale)


def test_control_reads_a_lower_precision():
    cfg, ref, _, w = setup("dense")
    tokens = torch.randint(1, cfg["vocab_size"], (64,),
                           generator=torch.Generator().manual_seed(3))
    plain = ref.logits(w, cfg, tokens)
    low = ref.logits(w, cfg, tokens, mm=check.fp8_mm)
    err = (low - plain).abs().max().item()
    # float8 e4m3 keeps 3 mantissa bits: errors of a few percent
    assert 1e-3 * plain.abs().max().item() < err


def test_weights_are_made_from_the_seed():
    cfg, ref, _, _ = setup("ssm")
    layout = ref.layout(cfg)
    a = weights.make(layout, 2 ** 31 + 5, "cpu", torch.float32)
    b = weights.make(layout, 2 ** 31 + 5, "cpu", torch.float32)
    c = weights.make(layout, 2 ** 31 + 6, "cpu", torch.float32)
    sa, sb, sc = (weights.shapes(x) for x in (a, b, c))
    assert sa == sb == sc
    emb = [x["embed"]["embedding"] for x in (a, b, c)]
    assert torch.equal(emb[0], emb[1]) and not torch.equal(emb[0], emb[2])
    lw = a["layers"]
    assert torch.all(lw["D"] == 1)
    # A = -exp(A_log) within the published 1..16; softplus(dt_bias)
    # within 0.001..0.1
    a_ = torch.exp(lw["A_log"])
    dt = torch.nn.functional.softplus(lw["dt_bias"])
    assert a_.min() >= 1 - 1e-5 and a_.max() <= 16 + 1e-4
    assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 0.1 * (1 + 1e-4)
    assert abs(a["embed"]["embedding"].std().item() - 0.1) < 0.01
