"""mfu.train: the training step's needed work (perfbench/counts/lm.py, from
the shapes) times the window's steps, over the window's length times the
card's bf16 peak, in %."""
from perfbench.counts import lm, peaks


def read(res):
    v = res.values
    if not v.get("steps"):
        return None
    flops = lm.train_step_flops(res.dims, v["batch"], v["seq_len"]) * v["steps"]
    return 100.0 * flops / (v["window_s"] * peaks.BF16_FLOPS)
