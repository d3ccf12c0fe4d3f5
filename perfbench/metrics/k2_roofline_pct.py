"""Kernel K2 (batched decode attention) against its roofline in the traced
sub-window: the least time for the attention of every token the pool
served there (each reading its stream's cache rows 0..pos once a layer;
``yardstick.attention_bound_s``) over the device time of the kernels
named here.  The work is counted from shapes, whatever kernel does it."""
from perfbench import profile
from perfbench import yardstick as Y

LAYER = "kernels"
SOURCE = "device_trace"
KERNELS = ("batched_decode_kernel",)


def read(run):
    if not run.trace:
        return None
    spent = profile.kernel_seconds(run.trace, KERNELS)
    if spent <= 0 or not run.blocks_sub:
        return None
    need = Y.attention_bound_s(Y.tts_rows(run.dcfg, run.blocks_sub),
                               run.dcfg.n_embd, run.config["dtype"]["decoder"])
    return 100.0 * need / spent
