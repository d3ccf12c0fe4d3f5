"""The reference against hand-worked values, and against the port's own
plain CPU path at a tiny size (the tests may import the port; the
reference does not)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import weights as W
from perfbench.reference import check, codec, decoder, schedule, text

EOS = "<|eot_id|>"


def test_sentences_by_hand():
    got = text.sentences(["Hi", "there.", "Ok.", EOS], EOS, 385)
    hi = [ord("H") + 3, ord("i") + 3, 1]
    there = [ord(c) + 3 for c in "there."] + [1]
    ok = [ord(c) + 3 for c in "Ok."] + [1]
    assert got == [(0, hi + there + [385]), (1, ok + [385]), (0, [1, 385])]


def test_sentences_eos_inside_a_sentence_and_closed_stream():
    got = text.sentences(["a", "b" + EOS], EOS, 385)
    assert got == [(0, [ord("a") + 3, 1, ord("b") + 3, 1, 385])]
    # no eos: the stream closes mid-sentence
    assert text.sentences(["a."," b"], EOS, 385) == [
        (0, [ord("a") + 3, ord(".") + 3, 1, 385]),
        (1, [ord("b") + 3, 1, 385])]


@pytest.mark.parametrize("raw,want", [
    ("a **b** c", "a b c"), ("x - y", "x y"), ("Rs 5. ok", "Rs 5 ok"),
    ("#1 & you @ home", " number 1 and you at home"),
    ("wait.... now", "wait pause  now"),
    ("1,000/2\\3", "1000 slash 2 backslash 3")])
def test_clean_text_by_hand(raw, want):
    from llmvox_tpu_torch.text.cleaning import clean_text
    assert text.clean_text(raw) == want == clean_text(raw)


def test_chunks_by_hand():
    scfg = SimpleNamespace(dump_growth_factor=3, max_dump_size=18,
                           max_audio_length=5, initial_dump_size_1=2,
                           initial_dump_size_2=4)
    chunks, dump, used = schedule.sentence_chunks(list(range(20)), 2, scfg,
                                                  -1)
    # dump 2 -> [0, 1]; dump 6 -> [2..7]; dump 18: the buffer passes 5 at
    # token 13 and the sentence ends, its 6 tokens dropped
    assert chunks == [[0, 1], [2, 3, 4, 5, 6, 7]]
    assert used == 14 and dump == 18
    # EOA flushes and ends; it is never vocoded
    chunks, _, used = schedule.sentence_chunks([5, 6, 7, 99, 8], 6, scfg, 99)
    assert chunks == [[5, 6, 7]] and used == 4
    got = schedule.request_chunks([(0, list(range(3))), (1, list(range(9)))],
                                  scfg, -1)
    assert [len(c) for c in got] == [2, 4]


def test_fp8_rounding_by_hand():
    w = torch.tensor([[448.0, 1.0], [-224.0, 0.5], [1.0, 0.25]])
    got = check.fp8_weight(w)
    assert got[0, 0] == 448.0 and got[1, 0] == -224.0
    assert got[:, 1].tolist() == [1.0, 0.5, 0.25]
    # 1 in a column scaled by 448 / 448: e4m3 keeps 3 bits of mantissa
    assert abs(check.fp8_weight(torch.tensor([[448.0], [3.3]]))[1, 0].item()
               - 3.25) < 1e-6


def test_istft_reconstructs_what_an_stft_analysed():
    n_fft, hop, t = 64, 16, 12
    total = (t - 1) * hop + n_fft
    x = torch.randn(total, dtype=torch.float64).float()
    win = torch.hann_window(n_fft, periodic=True)
    frames = x.unfold(0, n_fft, hop) * win
    spec = torch.fft.rfft(frames, dim=-1)
    y = codec.istft_same(spec, n_fft, hop)
    pad = (n_fft - hop) // 2
    assert y.shape == (t * hop,)
    assert torch.allclose(y, x[pad:total - pad], atol=1e-5)


def _tiny():
    dcfg = SimpleNamespace(n_layer=1, n_head=2, n_embd=8, vocab_size=5,
                           pad_token_id=3, ln_eps=1e-5)
    gen = torch.Generator().manual_seed(0)
    z = lambda *s: torch.zeros(s)  # noqa: E731
    params = {"wpe": torch.randn(6, 8, generator=gen),
              "lnf_s": torch.ones(8), "head": torch.randn(8, 5,
                                                          generator=gen),
              "h": {"ln1_s": torch.ones(1, 8), "wqkv": z(1, 8, 24),
                    "wo": z(1, 8, 8), "ln2_s": torch.ones(1, 8),
                    "wfc": z(1, 8, 32), "wproj": z(1, 32, 8)}}
    table = torch.randn(4, 3, generator=gen)
    book = torch.randn(5, 5, generator=gen)
    return dcfg, params, table, book


def test_decoder_with_silent_layers_by_hand():
    # with every layer matmul zero the residual stream is the input: the
    # L2-normalised [text row, previous token's codebook row] plus wpe
    dcfg, params, table, book = _tiny()
    ids, toks = [0, 2], [4, 1, 0]
    got = decoder.logits(params, table, book, dcfg, ids, toks)
    for p in range(3):
        t = table[ids[p]] if p < 2 else table[3]
        f = torch.zeros(5) if p == 0 else book[toks[p - 1]]
        x = torch.cat([t, f])
        x = x / x.norm() + params["wpe"][p]
        x = (x - x.mean()) / torch.sqrt(x.var(unbiased=False) + 1e-5)
        assert torch.allclose(got[p], x @ params["head"], atol=1e-5)


def test_decoder_is_causal():
    dcfg, params, table, book = _tiny()
    gen = torch.Generator().manual_seed(1)
    for k in ("wqkv", "wo", "wfc", "wproj"):
        params["h"][k] = torch.randn(params["h"][k].shape, generator=gen)
    a = decoder.logits(params, table, book, dcfg, [0, 1, 2], [1, 2, 3, 4])
    b = decoder.logits(params, table, book, dcfg, [0, 1, 2], [1, 2, 0, 0])
    # the logits at p read tokens before p only
    assert torch.allclose(a[:3], b[:3], atol=1e-6)
    assert not torch.allclose(a[3], b[3])


TINY_DEC = dict(n_layer=2, n_head=4, n_embd=64, block_size=256,
                vocab_size=512, text_embed_dim=32, speech_embed_dim=32)
TINY_CODEC = dict(vq_bins=512, vq_dim=32, backbone_input_channels=32,
                  backbone_dim=32, backbone_intermediate_dim=96,
                  backbone_num_layers=2)


def test_reference_follows_the_port_at_a_tiny_size():
    """The port's plain f32 CPU decode block and codec against the
    reference, on the same seeded weights."""
    from llmvox_tpu_torch.codec.codec import WavCodec
    from llmvox_tpu_torch.models import decoder as pdec
    from llmvox_tpu_torch.utils.config import CodecConfig, DecoderConfig
    dcfg = DecoderConfig(**TINY_DEC)
    ccfg = CodecConfig(**TINY_CODEC)
    dec = W.decoder_tree(5, dcfg, "cpu", torch.float32)
    table = W.text_table(5, dcfg, "cpu")
    ctree = W.codec_tree(5, ccfg, "cpu")
    book = ctree["codebooks"][0]
    ids = text.byt5("hello there.") + [385]
    state = pdec.init_decode_state(dcfg, torch.float32, "cpu")
    window = torch.full((48,), dcfg.pad_token_id, dtype=torch.int32)
    window[:len(ids)] = torch.tensor(ids)
    toks, n, _ = pdec.decode_block(
        dec, table, book, state, window, torch.tensor(len(ids)),
        torch.tensor(48), dcfg, block=48)
    toks = toks.tolist()
    lg = decoder.logits(dec, table, book, dcfg, ids, toks)
    gap = (lg.max(-1).values - lg.gather(1, torch.tensor(toks)[:, None])[:, 0])
    assert gap.max().item() < 1e-4
    wc = WavCodec(ctree, ccfg, device="cpu")
    codes = np.array([toks[:30]])
    want = wc.decode_codes_eager(codes)[0]
    got = codec.decode(ctree, ccfg, toks[:30]).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
