"""A copy of the benchmark's data files at a size the CPU runs in seconds:
the same cells, their configurations cut to width 64 (decoder) and 32
(codec), two clients, short sentences, no ramp."""
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

DEC = dict(n_layer=2, n_head=4, n_embd=64, block_size=1024, vocab_size=512,
           text_embed_dim=32, speech_embed_dim=32)
LLM = dict(vocab_size=384, n_layer=2, n_head=4, n_kv_head=2, n_embd=64,
           intermediate_size=128, n_experts=4)
CODEC = dict(vq_bins=512, vq_dim=32, backbone_input_channels=32,
             backbone_dim=32, backbone_intermediate_dim=96,
             backbone_num_layers=1)


def tiny_copy(dst: Path) -> Path:
    """The copy's ``perfbench`` folder (BENCHMARK.json beside it)."""
    root = dst / "perfbench"
    for part in ("configs", "workloads", "traffic/mixes", "metrics"):
        shutil.copytree(HERE / part, root / part,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", dst / "BENCHMARK.json")
    for p in (root / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        if "decoder" in cfg:
            cfg["decoder"].update(DEC)
            cfg["codec"].update(CODEC)
        if "llm" in cfg:
            cfg["llm"].update(LLM)
        p.write_text(json.dumps(cfg))
    for p in (root / "workloads").glob("*.json"):
        wl = json.loads(p.read_text())
        # an LLM's sentences run to ~150 text ids
        wl["serve"]["max_audio_length"] = 300 if wl["text"] == "llm" else 100
        if wl["serve"].get("pool_capacity"):
            wl["serve"]["pool_capacity"] = 4
        wl.update(ramp_s=0, drain_s=120)
        if "rate" in wl:
            wl["rate"] = 0.5
        wl["check"]["sample"] = 2
        p.write_text(json.dumps(wl))
    for p in (root / "traffic" / "mixes").glob("*.json"):
        mix = json.loads(p.read_text())
        if mix["loop"] == "closed":
            mix["clients"] = min(mix["clients"], 2)
        if "reply" in mix:
            mix["reply"]["chars"] = [20, 60]
        p.write_text(json.dumps(mix))
    return root
