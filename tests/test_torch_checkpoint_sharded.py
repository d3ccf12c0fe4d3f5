"""The port's sharded checkpoints (train/checkpoint.py::save_sharded /
load_sharded), the counterpart of the JAX package's ``save_orbax`` /
``load_orbax`` in a layout of the port's own: the JAX test's tree
against orbax's round trip, and the decoder trainer's FSDP shards
written by eight gloo ranks (dp 2 x sp 2 x tp 2, spawned once for the
module) read back whole, at their own layout and at others."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from llmvox_tpu_torch.parallel import sharding as psh
from llmvox_tpu_torch.parallel.launch import spawn
from llmvox_tpu_torch.train import checkpoint as ckpt
from llmvox_tpu_torch.utils import config as tconfig
from llmvox_tpu_torch.utils.params import init_decoder_params

from tests import torch_ckpt_ranks as ranks

# tests/test_torch_parallel_tp.py's decoder
DEC = tconfig.DecoderConfig(n_layer=2, n_head=4, n_embd=64, block_size=64,
                            vocab_size=16, bias=True, text_embed_dim=24,
                            speech_embed_dim=40, text_vocab_size=20,
                            pad_token_id=17, text_eos_id=18, eoa_token_id=7,
                            n_draft_heads=2)


def _jax_test_tree():
    """tests/test_train.py::test_orbax_roundtrip's tree."""
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": {"b": np.ones((4,), np.float32)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.numpy() if isinstance(
                v, torch.Tensor) else v)
    return out


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((DEC.text_vocab_size, DEC.text_embed_dim)
                                ).astype(np.float32)
    codebook = rng.standard_normal((DEC.vocab_size, DEC.speech_embed_dim)
                                   ).astype(np.float32)
    dec = dict(tcfg=tconfig.TrainConfig(batch_size=4, dp_size=-1,
                                        out_dir=str(tmp_path_factory.mktemp(
                                            "out"))),
               mcfg=DEC, table=table, codebook=codebook,
               params=init_decoder_params(4, DEC))
    path = str(tmp_path_factory.mktemp("sharded") / "ckpt")
    res = spawn(ranks.save_checks, 8, dec, path, threads=1, timeout_s=300)
    return dict(ranks=res, path=path, whole=res[0]["full"])


def test_port_round_trip_of_the_jax_tests_tree(tmp_path):
    """One process: the tree back whole, and cast to a template's dtypes
    (as orbax's ``restore(item=)``)."""
    tree = _jax_test_tree()
    path = str(tmp_path / "c")
    ckpt.save_sharded(path, tree)
    got = ckpt.load_sharded(path)
    _same(got, {"w": torch.from_numpy(tree["w"]),
                "nested": {"b": torch.from_numpy(tree["nested"]["b"])}})
    tmpl = {"w": np.zeros((2, 3), np.float64),
            "nested": {"b": torch.zeros(4, dtype=torch.bfloat16)}}
    got = ckpt.load_sharded(path, template=tmpl)
    assert got["w"].dtype == np.float64
    assert got["nested"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"], tree["w"])
    with pytest.raises(ValueError, match="template"):
        ckpt.load_sharded(path, template={"w": tmpl["w"]})


def test_round_trip_equals_orbaxs(tmp_path):
    """The JAX test's tree through the port's save and load equals JAX's
    save_orbax -> load_orbax of it (template zeros, as the JAX test
    restores)."""
    pytest.importorskip("orbax.checkpoint")
    import jax
    from llmvox_tpu.train import checkpoint as jckpt
    tree = _jax_test_tree()
    jpath = str(tmp_path / "orbax")
    jckpt.save_orbax(jpath, tree)
    want = jckpt.load_orbax(jpath,
                            template=jax.tree.map(np.zeros_like, tree))
    path = str(tmp_path / "port")
    ckpt.save_sharded(path, tree)
    got = ckpt.load_sharded(path, template=jax.tree.map(np.zeros_like, tree))
    _same(got, jax.tree.map(np.asarray, want))


def test_bf16_leaves_keep_their_dtype(tmp_path):
    tree = {"a": torch.randn(3, 5).to(torch.bfloat16),
            "b": [torch.arange(4, dtype=torch.int32)]}
    path = str(tmp_path / "c")
    ckpt.save_sharded(path, tree)
    got = ckpt.load_sharded(path)
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"],
                                                            tree["a"])
    assert torch.equal(got["b"][0], tree["b"][0])


def test_ranks_read_their_own_shards_back(saved):
    for out in saved["ranks"]:
        _same(out["back"], out["shards"])


def test_eight_ranks_load_whole_in_one_process(saved):
    """The tree written by eight ranks at dp 2 x sp 2 x tp 2 with FSDP,
    read whole in one process: the trainer's gathered tree."""
    layouts = {out["layout"] for out in saved["ranks"]}
    assert len(layouts) == 8
    got = ckpt.load_sharded(saved["path"])
    _same(got, saved["whole"])


@pytest.mark.parametrize("layout", [("dp", 4), ("tp", 2), ("dp x tp", 2)])
def test_loads_at_other_layouts(saved, layout):
    """Read at dp 4 with FSDP, at tp 2 (the fused QKV by heads) and at dp
    2 x tp 2 with FSDP: each rank's shard equals ``shard_tree`` of the
    whole."""
    whole = {k: v for k, v in saved["whole"].items()}
    name, n = layout
    for r in range(n * (2 if name == "dp x tp" else 1)):
        if name == "dp":
            specs, kw = psh.DECODER_FSDP_SPECS, dict(dp=n, dp_rank=r)
            want = psh.shard_tree(whole, specs, 1, 0, n, r)
        elif name == "tp":
            specs, kw = psh.DECODER_TP_SPECS, dict(tp=n, tp_rank=r)
            want = psh.shard_tree(whole, specs, n, r)
        else:
            specs = psh.DECODER_FSDP_SPECS
            kw = dict(dp=2, dp_rank=r // 2, tp=2, tp_rank=r % 2)
            want = psh.shard_tree(whole, specs, 2, r % 2, 2, r // 2)
        got = ckpt.load_sharded(saved["path"], specs=specs,
                                mp=ckpt.Layout(**kw))
        _same(got, {k: v for k, v in want.items()})


def test_each_shard_is_written_once(saved):
    """The index lists one shard a block: four for a leaf split over dp
    and tp, two for one split over tp alone, one for a whole leaf, each
    in the file of the first rank holding it."""
    with open(os.path.join(saved["path"], ckpt.SHARDED_INDEX)) as f:
        index = json.load(f)["leaves"]
    assert len(index["h/wqkv"]["shards"]) == 4
    assert len(index["h/bqkv"]["shards"]) == 2
    assert len(index["h/ln1_s"]["shards"]) == 1
    assert index["h/ln1_s"]["shards"][0]["file"] == "shards-0.npz"
    files = {s["file"] for leaf in index.values() for s in leaf["shards"]}
    # sp rank 1 (ranks 2, 3, 6, 7) holds copies of sp rank 0's shards
    assert files == {f"shards-{r}.npz" for r in (0, 1, 4, 5)}
    assert index["h/wqkv"]["shape"] == [2, DEC.n_embd, 3 * DEC.n_embd]


@pytest.mark.parametrize("leaf,keep", [("h/wqkv", 3), ("h/ln1_s", 0)])
def test_an_index_that_leaves_elements_uncovered_raises(saved, tmp_path,
                                                        leaf, keep):
    """An ``index.json`` that lists too few shards of a leaf (one block
    of four gone, or every shard) is refused on reading, whole and at a
    layout that wants the missing block, instead of coming back as
    zeros."""
    import shutil
    path = str(tmp_path / "ckpt")
    shutil.copytree(saved["path"], path)
    with open(os.path.join(path, ckpt.SHARDED_INDEX)) as f:
        doc = json.load(f)
    doc["leaves"][leaf]["shards"] = doc["leaves"][leaf]["shards"][:keep]
    with open(os.path.join(path, ckpt.SHARDED_INDEX), "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match=f"{leaf}.*cover"):
        ckpt.load_sharded(path)
    # dp rank 1 of dp 2 x tp 2 wants the last block of h/wqkv
    with pytest.raises(ValueError, match=f"{leaf}.*cover"):
        ckpt.load_sharded(path, specs=psh.DECODER_FSDP_SPECS,
                          mp=ckpt.Layout(dp=2, dp_rank=1, tp=2, tp_rank=1))
