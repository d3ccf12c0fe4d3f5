"""The benchmark's files against its contract: every name, unit and file
that ``BENCHMARK.json`` names; what each cell reports; imports checked in
a fresh interpreter by whole top-level module names; and the command's
refusal to run without a card."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.spec import Bench

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_units_and_files():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in DOC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in DOC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    cells = {w["name"] for w in DOC["workloads"]}
    for w in DOC["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        assert Bench().workload(w["name"])["why"] == w["why"]
    layers = {}
    for kind in ("end_to_end", "per_layer"):
        for m in DOC[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            assert set(m.get("workloads", cells)) <= cells
            mod = Bench().metric(m["name"])
            assert mod.SOURCE == m["source"]
            if kind == "per_layer":
                assert mod.LAYER == m["layer"]
                layers.setdefault(m["layer"], m["layer"])
                moves = next(e for e in DOC["end_to_end"]
                             if e["name"] == m["moves"])
                # every cell of the metric reports what it moves
                assert set(m["workloads"]) <= set(moves.get("workloads",
                                                            cells))
            else:
                assert m["source"] in ("host_clock", "device_trace")
                assert 0 < m["bound"] <= 0.25


def test_every_cell_reports_enough():
    b = Bench()
    for w in DOC["workloads"]:
        e2e = {m["name"] for m in b.metrics_for(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert b.metrics_for(w["name"], "per_layer")


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in "
                          "sys.modules}))"],
                         capture_output=True, text=True, cwd=str(ROOT),
                         check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))  # noqa: S307


FORBIDDEN = {"jax", "jaxlib", "flax", "llmvox_tpu"}


def test_harness_and_port_load_no_jax():
    mods = _loaded(
        "import perfbench.run, perfbench.harness, perfbench.system\n"
        "from perfbench.spec import Bench\n"
        "b = Bench()\n"
        "[b.metric(m['name']) for k in ('end_to_end', 'per_layer') "
        "for m in b.doc[k]]\n"
        "import llmvox_tpu_torch.serve.server, llmvox_tpu_torch.serve.pool\n"
        "import llmvox_tpu_torch.serve.engine, llmvox_tpu_torch.codec.codec\n"
        "import llmvox_tpu_torch.ops.build, llmvox_tpu_torch.utils.graphs\n")
    assert "llmvox_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    mods = _loaded("import perfbench.reference.check\n"
                   "import perfbench.reference.decoder\n"
                   "import perfbench.reference.codec\n")
    assert not mods & (FORBIDDEN | {"llmvox_tpu_torch"})


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        DOC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=str(ROOT))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_names_compare_whole(monkeypatch):
    from types import ModuleType
    from perfbench.run import forbidden_modules
    for name in ("llmvox_tpu_torch.fake", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, ModuleType(name))
    assert not set(forbidden_modules()) & {"llmvox_tpu_torch", "jaxtyping",
                                           "flaxen"}
    monkeypatch.setitem(sys.modules, "jax.numpy", ModuleType("jax.numpy"))
    assert "jax" in forbidden_modules()


@pytest.mark.card
def test_one_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        DOC["workloads"][0]["name"], "--seed", "12345",
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, cwd=str(ROOT),
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
