"""Pipeline-parallel Llama inference: the layers split over a ``pp``
group of ranks, microbatches flowing from stage to stage by a ring
rotation.

Counterpart of ``llmvox_tpu/models/llama_pp.py``.  JAX runs one
``shard_map`` program over a ``pp`` mesh axis (``ppermute`` between
stages, ``lax.cond`` to skip the fill and drain ticks); the port runs one
process a stage (``parallel/launch.py::spawn`` or ``torchrun``) and each
rank calls the same function with its own shard of the layers and of the
KV caches (``shard_llama_pp``, ``shard_pp_state``).

Schedule (JAX's, ``llmvox_tpu/models/llama_pp.py:101-332``): with n_pp
stages and M >= n_pp microbatches of a B-row pool, job j = (microbatch
j % M, token step j // M) enters stage 0 at tick j and stage s runs job
tick - s.  Token t+1 of a microbatch needs token t's sample, which
commits at tick t*M + m + n_pp - 1, before its entry tick (t+1)*M + m
exactly when M >= n_pp, so the pipeline never stalls.  Whether a stage
computes at a tick depends on (tick, stage) only, known to the host, so
the fill and drain ticks skip compute with a Python ``if``; every rank
still issues the same collectives every tick (one rotation of the
(B/M, T, C) activation, one all-reduce of the (B/M,) int32 tokens), or
the ranks would wait on each other for ever.  The last stage's tokens,
zeros on the others, are summed over the group every tick, which keeps
every stage's ``pos`` and ``tok`` equal: the returned registers are the
same on every rank.

Greedy tokens equal ``llama.decode_block_pooled``'s (and the prefill's
``llama.prefill_slots``'); sampled ones draw from the last stage's
``torch.Generator`` where JAX folds the tick into its key, so the two
agree in distribution.  Each stage's layer body is the pooled path's
(``llama._layer_step_rows``), the MoE routing its microbatch's rows.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from llmvox_tpu_torch.models import llama as L
from llmvox_tpu_torch.models.llama import LlamaConfig, LlamaPoolState
from llmvox_tpu_torch.ops import nn
from llmvox_tpu_torch.parallel import mesh as pmesh

PP_AXIS = "pp"


def pp_layers(cfg: LlamaConfig, pp: int, rank: int) -> slice:
    """The layers stage ``rank`` of ``pp`` holds: ``[rank L/pp, (rank+1)
    L/pp)`` (JAX's ``P("pp")`` on the layer axis)."""
    assert cfg.n_layer % pp == 0, "layers must split evenly over pp"
    per = cfg.n_layer // pp
    return slice(rank * per, (rank + 1) * per)


def shard_llama_pp(params: Dict, cfg: LlamaConfig, pp: int, rank: int
                   ) -> Dict:
    """Stage ``rank``'s params (JAX's ``llama_pp_param_shardings``): its
    layers of every stacked leaf of ``h``, everything else whole (stage 0
    needs the embedding, the last stage the head)."""
    sl = pp_layers(cfg, pp, rank)
    return {k: ({n: v[sl] for n, v in x.items()} if k == "h" else x)
            for k, x in params.items()}


def shard_pp_state(state: LlamaPoolState, cfg: LlamaConfig, pp: int,
                   rank: int) -> LlamaPoolState:
    """Stage ``rank``'s pool state (JAX's ``llama_pp_state_shardings``):
    its layers of the KV caches (a copy), ``pos`` and ``tok`` whole."""
    sl = pp_layers(cfg, pp, rank)
    return LlamaPoolState(state.k[sl].clone(), state.v[sl].clone(),
                          state.pos.clone(), state.tok.clone())


def _stage(params: Dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           pos: torch.Tensor, cfg: LlamaConfig,
           token_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """This stage's layers over one microbatch (B/M, T, C) whose rows sit
    at ``pos``, writing their K and V rows of the microbatch's caches
    (L/pp, B/M, S, KV, hd) in place."""
    tables = L._row_tables(pos, x.shape[1], k.shape[2], None, cfg,
                           x.device)
    for layer in range(k.shape[0]):
        x = L._layer_step_rows(L._layer_params(params, layer), x, k[layer],
                               v[layer], tables, cfg, token_mask)
    return x


class _Schedule:
    """What every tick shares: the group, its size and this stage."""

    def __init__(self, group, cfg: LlamaConfig, n_micro: int):
        self.group = group
        self.n_pp = pmesh.group_size(group)
        self.stage = pmesh.group_rank(group)
        self.M = n_micro or self.n_pp
        assert self.M >= self.n_pp, (f"need n_micro >= pp ({self.M} < "
                                     f"{self.n_pp})")
        assert cfg.n_layer % self.n_pp == 0, (
            "layers must split evenly over pp")
        self.last = self.stage == self.n_pp - 1

    def job(self, tick: int, stage: int, n_jobs: int) -> Optional[int]:
        j = tick - stage
        return j if 0 <= j < n_jobs else None

    def exchange(self, send: torch.Tensor, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the activation stage - 1 sent, the last stage's tokens):
        every rank, every tick."""
        recv = pmesh.rotate(send, self.group, 1)
        if self.n_pp > 1:
            buf = tokens.to(pmesh._collective_device(tokens.device),
                            copy=True)
            dist.all_reduce(buf, group=self.group)
            tokens = buf.to(tokens.device)
        return recv, tokens


def make_pp_decode(group, cfg: LlamaConfig, block: int = 16,
                   n_micro: int = 0, temperature: float = 0.0,
                   top_k: int = 0, top_p: float = 1.0):
    """JAX's ``make_pp_decode`` over the pp ``group``: ``fn(params, state,
    active, generator=None) -> ((B, block) tokens, state)``, the pipelined
    ``llama.decode_block_pooled`` (greedy tokens equal).  ``params`` and
    ``state`` are this stage's (``shard_llama_pp``, ``shard_pp_state``);
    the caches are written in place and the returned state holds the new
    ``pos`` and ``tok``, the same on every stage.  ``n_micro`` (M)
    defaults to the pp size and must divide B with M >= pp.  Inactive rows
    ride along: their writes park on their frozen ``pos`` (the row is
    prefilled again before reuse), their ``pos`` and ``tok`` stay."""
    sch = _Schedule(group, cfg, n_micro)
    M, n_pp, s = sch.M, sch.n_pp, sch.stage

    def fn(params, state: LlamaPoolState, active: torch.Tensor,
           generator: Optional[torch.Generator] = None):
        b = state.tok.shape[0]
        assert b % M == 0, f"{M} microbatches do not split {b} rows"
        bm = b // M
        n_jobs = M * block
        dev = state.tok.device
        act = active.bool()
        emb = params["tok_emb"]
        tok, pos = state.tok.clone(), state.pos.clone()
        out = torch.zeros((block, b), dtype=torch.int32, device=dev)
        send = torch.zeros((bm, 1, cfg.n_embd), dtype=emb.dtype, device=dev)
        zeros = torch.zeros((bm,), dtype=torch.int32, device=dev)
        recv = None     # stage s > 0 computes from tick s on, after one
        with torch.no_grad():
            for tick in range(n_jobs + n_pp - 1):
                j = sch.job(tick, s, n_jobs)
                x = send
                nxt = zeros
                if j is not None:
                    rows = slice((j % M) * bm, (j % M + 1) * bm)
                    x = emb[tok[rows]][:, None] if s == 0 else recv
                    x = _stage(params, x, state.k[:, rows],
                               state.v[:, rows], pos[rows], cfg,
                               act[rows, None])
                    if sch.last:
                        h = L.rms_norm(x[:, -1], params["lnf_s"],
                                       cfg.rms_eps)
                        nxt = L._sample(nn.linear(h, L._head(params)),
                                        temperature, top_k, top_p,
                                        generator)
                        nxt = torch.where(act[rows], nxt, tok[rows])
                send = x
                recv, sampled = sch.exchange(send, nxt)
                jl = sch.job(tick, n_pp - 1, n_jobs)
                if jl is not None:
                    rows = slice((jl % M) * bm, (jl % M + 1) * bm)
                    tok[rows] = sampled
                    pos[rows] += act[rows].to(torch.int32)
                    out[jl // M, rows] = sampled
        return out.t().contiguous(), state._replace(pos=pos, tok=tok)

    return fn


def make_pp_prefill(group, cfg: LlamaConfig, n_micro: int = 0,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0):
    """JAX's ``make_pp_prefill`` over the pp ``group``: ``fn(params,
    tokens (B, Tpad), valid_lens (B,), state, generator=None) -> ((B,)
    first tokens, state)``, the pipelined ``llama.prefill_slots`` of a
    whole fresh pool (row b into slot b; microbatches of rows flow through
    the stages).  Each row's rows 0..Tpad-1 of this stage's caches are
    written (pad positions above ``valid_lens`` stay hidden by the decode
    mask until overwritten); the head runs at each row's last valid
    position, as ``prefill_slots``' does; ``pos`` becomes ``valid_lens``
    and ``tok`` the first tokens, on every stage."""
    sch = _Schedule(group, cfg, n_micro)
    M, n_pp, s = sch.M, sch.n_pp, sch.stage

    def fn(params, tokens: torch.Tensor, valid_lens: torch.Tensor,
           state: LlamaPoolState,
           generator: Optional[torch.Generator] = None):
        b, tpad = tokens.shape
        assert b % M == 0, f"{M} microbatches do not split {b} rows"
        bm = b // M
        dev = tokens.device
        emb = params["tok_emb"]
        vl = valid_lens.to(torch.int32)
        tok, pos = state.tok.clone(), state.pos.clone()
        send = torch.zeros((bm, tpad, cfg.n_embd), dtype=emb.dtype,
                           device=dev)
        zeros = torch.zeros((bm,), dtype=torch.int32, device=dev)
        recv = None
        with torch.no_grad():
            for tick in range(M + n_pp - 1):
                j = sch.job(tick, s, M)
                x = send
                nxt = zeros
                if j is not None:
                    rows = slice(j * bm, (j + 1) * bm)
                    mask = (torch.arange(tpad, device=dev)[None]
                            < vl[rows, None])
                    x = emb[tokens[rows]] if s == 0 else recv
                    # a fresh row attends its own Tpad rows only, as
                    # prefill_slots' fresh caches do
                    x = _stage(params, x, state.k[:, rows, :tpad],
                               state.v[:, rows, :tpad], zeros, cfg, mask)
                    if sch.last:
                        nxt = L._sample(L._head_rows(params, x, vl[rows],
                                                     cfg),
                                        temperature, top_k, top_p,
                                        generator)
                send = x
                recv, sampled = sch.exchange(send, nxt)
                jl = sch.job(tick, n_pp - 1, M)
                if jl is not None:
                    rows = slice(jl * bm, (jl + 1) * bm)
                    tok[rows] = sampled
                    pos[rows] = vl[rows]
        return tok.clone(), state._replace(pos=pos, tok=tok)

    return fn
