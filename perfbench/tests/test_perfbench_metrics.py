"""The arithmetic of every metric: percentiles over all requests, rates
over the window, the idle share from a made-up kernel timeline, and the
FLOP and byte counts of the rooflines and MFU, against hand-worked
values."""
from types import SimpleNamespace

import pytest

from perfbench import profile
from perfbench import yardstick as Y
from perfbench.harness import MISSING, Run
from perfbench.spec import Bench
from perfbench.stats import percentile

BENCH = Bench()


def metric(name):
    return BENCH.metric(name)


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == 95
    assert percentile(xs, 99) == 99
    assert percentile(list(reversed(xs)), 50) == 50
    assert percentile([3.0], 95) == 3.0
    assert percentile([], 95) is None
    # 20 values: the 19th smallest
    assert percentile(list(range(20)), 95) == 18


def _run(sent, chunks=(), window=(0.0, 10.0), **kw):
    return Run(sent=sent, chunks=list(chunks), window=window,
               seconds=window[1] - window[0],
               ccfg=SimpleNamespace(hop_length=320, sample_rate=24000), **kw)


def _req(due, first, last, audio_s, ok=True):
    return {"due": due, "chunks": [(first, 1), (last, 1)], "ok": ok,
            "audio_s": audio_s}


def test_ttfa_and_rtf_take_every_request():
    sent = [_req(i, i + 0.01 * (i + 1), i + 1.0, 2.0) for i in range(20)]
    run = _run(sent)
    # first audio 10, 20, .. 200 ms after due: the 19th is 190 ms
    assert metric("ttfa_p95_ms").read(run) == pytest.approx(190.0)
    # every request: 1 s over 2 s of audio
    assert metric("rtf_p95").read(run) == pytest.approx(0.5)


def test_failed_requests_read_as_missing():
    sent = [_req(i, i + 0.1, i + 1.0, 2.0) for i in range(18)]
    sent += [_req(18, 0, 0, 0, ok=False), _req(19, 0, 0, 0, ok=False)]
    run = _run(sent)
    assert metric("ttfa_p95_ms").read(run) == MISSING
    assert metric("rtf_p95").read(run) == MISSING


def test_audio_rate_counts_the_window_only():
    # frames of 320 samples: 75 frames = 1 s of audio
    chunks = [(-0.5, 75), (0.0, 75), (5.0, 150), (9.99, 75), (10.0, 750)]
    run = _run([], chunks, window=(0.0, 10.0))
    assert metric("audio_s_per_s").read(run) == pytest.approx(4.0 / 10.0)


def test_idle_share_from_a_timeline():
    ops = [("a", -1.0, 0.5), ("b", 0.25, 1.0), ("a", 1.5, 2.0),
           ("c", 1.75, 1.8), ("b", 3.5, 9.0)]
    spans = [(2.2, 3.0, "pool step launch")]
    red = profile.reduce_ops(ops, 0.0, 4.0, spans)
    # busy: [0, 1] + [1.5, 2] + [3.5, 4] = 2.0 of 4.0
    assert red["busy_s"] == pytest.approx(2.0)
    assert red["kernels"]["a"] == pytest.approx(1.0)
    assert red["kernels"]["b"] == pytest.approx(1.25)
    assert red["idle_gaps"][0] == ("host: pool step launch",
                                   pytest.approx(1.5))
    assert red["idle_gaps"][1][1] == pytest.approx(0.5)
    run = Run(trace=red)
    assert red["n_ops"] == 5
    assert metric("device_idle_pct.pool").read(run) == pytest.approx(50.0)


def test_decoder_flops_by_hand():
    cfg = SimpleNamespace(n_layer=1, n_embd=2, vocab_size=3)
    # a token: 24 C^2 + 2 C V = 96 + 12; attention 4 C (pos + 1)
    assert Y.decoder_token_flops(cfg, 0) == 108 + 8
    assert Y.decoder_token_flops(cfg, 1) == 108 + 16
    assert Y.decoder_flops(cfg, [(2, 0)]) == 108 * 2 + 24
    assert Y.decoder_flops(cfg, [(3, 5)]) == sum(
        Y.decoder_token_flops(cfg, p) for p in (5, 6, 7))


def test_codec_flops_by_hand():
    cfg = SimpleNamespace(backbone_dim=2, backbone_intermediate_dim=3,
                          backbone_input_channels=4, backbone_num_layers=1,
                          n_fft=6)
    want = (2 * 7 * 4 * 2 + 8 * 2 * 3 * 4 + 4 * 2 * 4 + 4 * 5 * 2
            + (2 * 7 * 2 + 4 * 2 * 3) + 2 * 2 * 8)
    assert Y.codec_frame_flops(cfg, 5) == want


def test_attention_bound_by_hand():
    # one stream, 128 rows of 768 bf16: K and V 393216 bytes, q and out
    # 3072, pos 4
    t = Y.attention_bound_s([128], 768, "bfloat16")
    assert t == pytest.approx(396292 / 3.35e12)
    cfg = SimpleNamespace(n_layer=2)
    assert list(Y.tts_rows(cfg, [(2, 3)])) == [4, 4, 5, 5]


def test_k2_roofline_and_mfu_readers():
    dcfg = SimpleNamespace(n_layer=4, n_embd=768, vocab_size=4096)
    ccfg = SimpleNamespace(backbone_dim=768, backbone_intermediate_dim=2304,
                           backbone_input_channels=512,
                           backbone_num_layers=12, n_fft=1280,
                           hop_length=320, sample_rate=24000)
    config = {"dtype": {"decoder": "bfloat16", "codec": "float32"}}
    blocks = [(64, 0), (64, 64), (32, 300)]
    need = Y.attention_bound_s(Y.tts_rows(dcfg, blocks), 768, "bfloat16")
    trace = {"kernels": {"void batched_decode_kernel<bf16>": 4 * need,
                         "gemm": 1.0}, "busy_s": 1.0, "window_s": 2.0}
    run = Run(trace=trace, blocks_sub=blocks, dcfg=dcfg, config=config)
    assert metric("k2_roofline_pct").read(run) == pytest.approx(25.0)
    run = Run(blocks_window=blocks, dcfg=dcfg, ccfg=ccfg, config=config,
              window=(0.0, 2.0), seconds=2.0,
              chunks=[(0.5, 10), (1.0, 30), (3.0, 90)])
    want = (Y.decoder_flops(dcfg, blocks) / 989e12
            + (10 * Y.codec_frame_flops(ccfg, 10)
               + 30 * Y.codec_frame_flops(ccfg, 30)) / 67e12) / 2.0 * 100
    assert metric("tts_mfu_pct.pool").read(run) == pytest.approx(want)


def test_counter_readers():
    counters = {"w0": {"pool_steps": 10, "pool_dispatch_s": 1.0,
                       "pool_decode_steps": 640},
                "w1": {"pool_steps": 30, "pool_dispatch_s": 1.05,
                       "pool_decode_steps": 1920},
                "s0": {"pool_decode_steps": 1000},
                "s1": {"pool_decode_steps": 1500}}
    run = Run(counters=counters, blocks_window=[(64, 0)] * 240,
              trace={"busy_s": 0.25, "window_s": 0.5, "n_ops": 9})
    assert metric("pool_host_ms_per_step.full").read(run) == \
        pytest.approx(2.5)
    assert metric("pool_rows_per_token_step").read(run) == pytest.approx(12.0)
    assert metric("pool_device_ms_per_token_step").read(run) == \
        pytest.approx(0.5)
    assert metric("loop_lag_p99_ms").read(
        Run(lags=[0.001 * i for i in range(100)])) == pytest.approx(98.0)


def test_readers_without_a_trace_return_nothing():
    empty = {"busy_s": 0.0, "window_s": 1.0, "n_ops": 0, "kernels": {}}
    for trace in (None, empty):
        run = Run(trace=trace, lags=None, counters={"s0": {
            "pool_decode_steps": 0, "engine_decode_steps": 0}, "s1": {
            "pool_decode_steps": 64, "engine_decode_steps": 64}},
            blocks_sub=[(64, 0)])
        for name in ("k2_roofline_pct", "k1_roofline_pct",
                     "device_idle_pct.pool", "device_idle_pct.voice",
                     "device_idle_pct.dedicated", "b1_device_us_per_token",
                     "pool_device_ms_per_token_step", "loop_lag_p99_ms"):
            assert metric(name).read(run) is None, name
