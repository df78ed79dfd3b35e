"""The counters behind the rooflines and the model-FLOPs share, against
shapes worked by hand."""
import json

import pytest

from harness import layers, work
from harness.manifest import load_module
from harness.work import Tick

from conftest import BENCH

OLMO = json.loads((BENCH / "configs" / "olmo-1b.json").read_text())
MAMBA = json.loads((BENCH / "configs" / "mamba2-1.3b.json").read_text())


def reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "t_" + name.replace(".", "_"))


def test_dense_weight_flops_by_hand():
    # per layer: q, k, v, o 4 * 2048 * 2048, SwiGLU 3 * 2048 * 8192;
    # the unembedding 2048 * 50304
    per = 4 * 2048 * 2048 + 3 * 2048 * 8192
    assert work.weight_flops(OLMO) == 2.0 * (16 * per + 2048 * 50304)


def test_ssm_weight_flops_by_hand():
    d, di, n, h = 2048, 4096, 128, 64
    per = d * (2 * di + 2 * n + h) + di * d + 4 * (di + 2 * n)
    assert work.weight_flops(MAMBA) == 2.0 * (48 * per + d * 50280)


def test_tick_flops_counts_decodes_and_causal_prefill():
    t = Tick(0.0, 1.0, decode_ctx=[10, 20], first=[4], cont=[(6, 2)])
    wf = work.weight_flops(OLMO)
    att = 4.0 * 16 * 16 * 128          # layers * heads * head_dim * 4
    # decodes attend 10 + 20 keys; the prompt of 4 attends 1+2+3+4; the
    # chunk after 6 tokens attends 7 + 8
    want = 2 * wf + 4 * wf + 2 * wf + att * (30 + 10 + 15)
    assert work.tick_flops(OLMO, t) == pytest.approx(want)


def test_paged_decode_work_by_hand():
    w = reader("paged_decode_attention_roofline").work
    flops, nbytes = w(OLMO, Tick(0, 1, decode_ctx=[33], first=[], cont=[]))
    assert flops == 4.0 * 16 * 128 * 33
    # q and out: 2 * 16 * 128; K and V: 2 * 33 * 16 * 128; bf16; a table
    # row of 3 pages and the length, int32
    assert nbytes == (2 * 16 * 128 + 2 * 33 * 16 * 128) * 2 + 4 * (3 + 1)


def test_segment_flash_work_by_hand():
    w = reader("segment_flash_attention_roofline").work
    flops, nbytes = w(OLMO, Tick(0, 1, [], first=[3, 5], cont=[(9, 4)]))
    assert flops == 4.0 * 16 * 128 * (6 + 15)
    assert nbytes == (3 + 5) * (2 * 16 + 2 * 16) * 128 * 2


def test_ssd_scan_work_by_hand():
    w = reader("ssd_scan_roofline").work
    flops, nbytes = w(MAMBA, Tick(0, 1, [], first=[100], cont=[]))
    assert flops == 4.0 * 4096 * 128 * 100
    # x and y bf16, dt float32 per head, B and C bf16; the final state
    # float32 (64 heads, 128 x 64)
    assert nbytes == 100 * (2 * 4096 * 2 + 4 * 64 + 2 * 128 * 2) \
        + 4 * 64 * 128 * 64


class _Dev:
    def __init__(self, window_s, busy_s, by_symbol):
        self.window_s, self.busy_s, self.by_symbol = (window_s, busy_s,
                                                      by_symbol)

    def seconds_of(self, symbols):
        return sum(self.by_symbol.get(s, 0.0) for s in symbols)


class _Cell:
    config = OLMO


class _Run:
    def __init__(self, ticks, dev):
        self.ticks, self.device, self.cell = ticks, dev, _Cell()


def test_roofline_share_is_least_time_over_kernel_time():
    t = Tick(0, 1, decode_ctx=[1000] * 128, first=[], cont=[])
    r = reader("paged_decode_attention_roofline")
    flops, nbytes = r.work(OLMO, t)
    least = 16 * max(flops / work.PEAK_FLOPS, nbytes / work.PEAK_BYTES)
    run = _Run([t, t], _Dev(1.0, 0.5, {"paged_split_kernel": 4 * least}))
    # two ticks' least time over four ticks' worth of kernel time
    assert r.read(run) == pytest.approx(50.0)
    assert reader("segment_flash_attention_roofline").read(run) is None


def test_mfu_and_idle_share():
    t = Tick(0, 1, decode_ctx=[100], first=[], cont=[])
    run = _Run([t], _Dev(2.0, 1.5, {}))
    want = 100.0 * work.tick_flops(OLMO, t) / (2.0 * work.PEAK_FLOPS)
    assert layers.mfu(run) == pytest.approx(want)
    assert layers.idle_share(run) == pytest.approx(25.0)
    run.device = None
    assert layers.mfu(run) is None and layers.idle_share(run) is None
