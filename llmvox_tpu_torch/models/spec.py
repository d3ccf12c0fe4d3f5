"""What speculative decode shares between the speech decoder
(``models/decoder.py``) and the Llama (``models/llama.py``): the check of
the draft heads, and the host loop that issues a speculative block one
iteration ahead of the card's "any row active" flag."""
from __future__ import annotations

from typing import Dict

import torch

from llmvox_tpu_torch.utils.device import Fetch


def check_draft_heads(params: Dict, cfg, k: int) -> None:
    """Raise unless ``params["draft_heads"]`` is an (n, C, vocab) tensor
    with n >= k: speculation at k drafts reads heads 0..k-1.  ``cfg`` is
    the speech decoder's config or the Llama's (both name ``n_embd`` and
    ``vocab_size``)."""
    heads = params["draft_heads"]
    want = (cfg.n_embd, cfg.vocab_size)
    if (not isinstance(heads, torch.Tensor) or heads.dim() != 3
            or tuple(heads.shape[1:]) != want or heads.shape[0] < k):
        shape = (tuple(heads.shape) if isinstance(heads, torch.Tensor)
                 else type(heads).__name__)
        raise ValueError(f"speculative decode at {k} drafts needs "
                         f"draft_heads of shape (>= {k}, {want[0]}, "
                         f"{want[1]}); got {shape}")


def run_spec_loop(start, iterate, flag: torch.Tensor, block: int) -> int:
    """Issue one speculative block: ``start()``, then up to ``block`` calls
    of ``iterate()`` (eager bodies, or one graph replay each).  JAX's
    ``lax.while_loop`` runs until no stream is active.  Here the 0-d
    ``flag`` is copied to pinned host memory after each call without
    blocking, and the host waits for iteration i's flag only before it
    issues iteration i+2, so it stays one iteration ahead of the card.
    So one iteration more than JAX's is issued (none more than
    ``block``): it is masked and commits nothing.  The copies are issued
    here, outside any graph: an event recorded inside a capture cannot be
    waited for.  Returns the number of iterations issued."""
    start()
    flags = [Fetch(flag)]      # flags[i]: is any stream active before i
    for i in range(block):
        if i >= 1 and not bool(flags[i - 1].get()):
            return i
        iterate()
        flags.append(Fetch(flag))
    return block
