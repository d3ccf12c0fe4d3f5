"""Host milliseconds the LLM pool spends planning and launching an
iteration (its ``dispatch_s``), over the window's iterations (``steps``)."""
LAYER = "LLM pool"
SOURCE = "program_counter"


def read(run):
    steps = run.delta("llm_steps")
    if not steps:
        return None
    return run.delta("llm_dispatch_s") / steps * 1e3
