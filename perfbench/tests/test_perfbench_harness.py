"""Whole runs of the harness on the CPU at a tiny size, its look for a
card skipped: a clean run is correct; a token altered where the pool
produces it is not; the float8 control, judged by the same limits, is not
correct either; the LLM's tokens altered where produced are caught; a
cell and a metric added as files in a copy run with no code edited."""
import json
import shutil

import pytest

from perfbench.harness import run_cell
from perfbench.spec import Bench
from perfbench.tests.tiny import tiny_copy

CELL = "tts-pool16-closed8"
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


def _run(root, cell=CELL, trace=False, control=False, seconds=4.0):
    return run_cell(cell, SEED, seconds, trace, device="cpu",
                    bench=Bench(root=root), control=control)


def test_clean_run_is_correct_and_the_control_is_not(tiny, tmp_path,
                                                     monkeypatch):
    """The tiny decoder at the deployed logit spread: its 4096 codes and
    a head scaled by sqrt(768 / 64), the width it stands in for.  Its
    limit on ``token_gap`` is the tiny cell's own, 0.03, between the
    program's readings (0.002-0.008 on three seeds) and the float8
    control's (0.044-0.057); TF32 changes nothing on the CPU, so the
    control has to fail there."""
    import perfbench.weights as W
    root = tmp_path / "perfbench"
    shutil.copytree(tiny, root)
    shutil.copy(tiny.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = root / "configs" / "llmvox-wavtokenizer.json"
    cfg = json.loads(path.read_text())
    cfg["decoder"]["vocab_size"] = cfg["codec"]["vq_bins"] = 4096
    path.write_text(json.dumps(cfg))
    path = root / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl["check"]["limits"]["token_gap"] = 0.03
    path.write_text(json.dumps(wl))
    tree = W.decoder_tree

    def wide_head(*a, **k):
        t = tree(*a, **k)
        t["head"].mul_((768 / 64) ** 0.5)
        return t

    monkeypatch.setattr(W, "decoder_tree", wide_head)
    res = _run(root, control=True)
    checks = res["checks"]
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"rtf_p95", "setup_s", "audio_s_per_s"}
    gap = checks["token_gap"]["value"]
    assert checks["control_token_gap"]["value"] > 3 * gap
    # judged against the cell's own limits, the control fails
    assert res["control_correct"] is False
    assert any(c["value"] > c["limit"] for k, c in checks.items()
               if k.startswith("control_"))


def test_a_token_altered_where_produced_is_caught(tiny, monkeypatch):
    from llmvox_tpu_torch.serve.pool import PooledEngine
    orig = PooledEngine._Pending.afetch
    hit = []

    async def altered(self):
        toks = await orig(self)
        if toks and not hit:
            hit.append(1)
            toks = [(toks[0] + 1) % 512] + list(toks[1:])
        return toks

    monkeypatch.setattr(PooledEngine._Pending, "afetch", altered)
    res = _run(tiny)
    assert hit
    assert not res["correct"]


def test_a_cell_and_a_metric_added_as_files(tiny, tmp_path):
    root = tmp_path / "perfbench"
    shutil.copytree(tiny, root)
    doc = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    new = dict(json.loads((root / "workloads" / f"{CELL}.json").read_text()))
    new["serve"] = dict(new["serve"], pool_capacity=2)
    (root / "workloads" / "tts-pool2-closed2.json").write_text(
        json.dumps(new))
    doc["workloads"].append({"name": "tts-pool2-closed2",
                             "config": new["config"],
                             "traffic": new["traffic"], "chips": 1,
                             "why": "a cell added as a file"})
    (root / "metrics" / "requests_sent.py").write_text(
        'LAYER = "server and scheduler"\nSOURCE = "host_clock"\n\n\n'
        "def read(run):\n    return float(len(run.sent))\n")
    doc["end_to_end"].append({"name": "requests_sent", "unit": "requests",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["tts-pool2-closed2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    res = _run(root, cell="tts-pool2-closed2")
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_sent"]["value"] == res["attempted"]


def test_traced_run_reports_the_per_layer_metrics(tiny):
    res = _run(tiny, trace=True)
    assert res["correct"], res["checks"]
    assert "busy_s" in res["device"] and "breakdown" in res
    assert "pool_host_ms_per_step.full" in res["metrics"]
    assert "ttfa_p95_ms" not in res["metrics"]


@pytest.mark.parametrize("cell", [w["name"] for w in Bench().doc["workloads"]
                                  if w["name"] != CELL])
def test_every_other_cell_runs_correct(tiny, cell):
    res = _run(tiny, cell=cell, seconds=6.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0


def test_altered_llm_tokens_are_caught(tiny, monkeypatch):
    """Every token the LLM pool serves moved to the next byte: the text
    stays consistent with the tokens, and the share of tokens that miss
    the reference's best by half a logit rises past the limit.  The tiny
    model's head is scaled to the deployed width's logit spread
    (sqrt(4096 / 64)), so half a logit means what it means there."""
    from llmvox_tpu_torch.serve.llm_pool import LLMPool
    import perfbench.weights as W
    tree = W.llm_tree

    def wide_head(*a, **k):
        t = tree(*a, **k)
        t["head"].mul_(8.0)
        return t

    monkeypatch.setattr(W, "llm_tree", wide_head)
    res = _run(tiny, cell="voice-mixtral8-open", seconds=6.0)
    assert res["correct"], res["checks"]
    orig = LLMPool.generate

    def altered(pool, *a, **k):
        gen = orig(pool, *a, **k)

        async def out():
            async for toks in gen:
                yield [t + 1 if 0 < t < 127 else t for t in toks]
        return out()

    monkeypatch.setattr(LLMPool, "generate", altered)
    res = _run(tiny, cell="voice-mixtral8-open", seconds=6.0)
    assert res["checks"]["text_mismatch"]["value"] == 0
    assert res["checks"]["llm_miss_share"]["value"] > \
        res["checks"]["llm_miss_share"]["limit"]
    assert not res["correct"]


@pytest.mark.card
def test_the_control_is_not_correct_on_the_card():
    """The control at the cell's own size on the card, three seeds, each
    judged against the cell's limits (``control.py`` exits 1 where a
    control reads correct or the program does not)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card")
    from perfbench import control
    seeds = ",".join(str(2 ** 31 + k) for k in (101, 102, 103))
    assert control.main(["--workload", CELL, "--seeds", seeds,
                         "--seconds", "10"]) == 0
