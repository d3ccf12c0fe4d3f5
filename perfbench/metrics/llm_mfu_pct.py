"""The LLM's share of the card's bf16 peak over the window: the FLOPs of
every forward that made the tokens served there (the prompt past the
cached system prefix, and each generated token; only the routed top-2
experts counted, attention over the context; ``yardstick.llm_flops``),
as the seconds the card would need at peak, over the window's seconds."""
from perfbench import yardstick as Y

LAYER = "model step"
SOURCE = "program_counter"


def read(run):
    if run.lcfg is None or not run.llm_window:
        return None
    need = Y.llm_flops(run.lcfg, run.llm_window) / Y.PEAK_FLOPS[
        run.config["dtype"]["llm"]]
    return 100.0 * need / run.seconds
