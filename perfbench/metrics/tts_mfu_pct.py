"""The whole TTS step's share of the card's peak over the window: the
speech decoder's FLOPs for every token served (bf16 peak) and the codec's
for every frame the clients received (f32 peak, TF32 off), as the
seconds the card would need at peak, over the window's seconds."""
from perfbench import yardstick as Y

LAYER = "model step"
SOURCE = "program_counter"


def read(run):
    cfg = run.config["dtype"]
    dec = Y.decoder_flops(run.dcfg, run.blocks_window)
    w0, w1 = run.window
    codec = sum(n * Y.codec_frame_flops(run.ccfg, n)
                for t, n in run.chunks if w0 <= t < w1)
    need = (dec / Y.PEAK_FLOPS[cfg["decoder"]]
            + codec / Y.PEAK_FLOPS[cfg["codec"]])
    return 100.0 * need / run.seconds if need else None
