"""Kernel K1 (B=1 decode attention) against its roofline in the traced
sub-window: the least time for the attention of every token the replicas
served there (each reading its sentence's cache rows 0..pos once a
layer; ``yardstick.attention_bound_s``) over the device time of the
kernels named here.  The work is counted from shapes, whatever kernel
does it."""
import re

from perfbench import yardstick as Y

LAYER = "kernels"
SOURCE = "device_trace"
KERNEL = re.compile(r"(?<![A-Za-z_])decode_kernel\b")


def read(run):
    if not run.trace:
        return None
    spent = sum(s for n, s in run.trace["kernels"].items()
                if KERNEL.search(n))
    if spent <= 0 or not run.blocks_sub:
        return None
    need = Y.attention_bound_s(Y.tts_rows(run.dcfg, run.blocks_sub),
                               run.dcfg.n_embd, run.config["dtype"]["decoder"])
    return 100.0 * need / spent
