"""mfu.serve: the model work the window's served tokens need (each
prompt's prefill, each decoded token against its own valid positions;
perfbench/counts/lm.py) over the window's length times the card's bf16
peak, in %."""
from perfbench.counts import lm, peaks


def read(res):
    v = res.values
    lengths, steps = v.get("prefill_lengths") or [], v.get("decode_rows") or []
    if not lengths and not any(steps):
        return None
    flops = sum(lm.prefill_flops(res.dims, s) for s in lengths)
    flops += sum(lm.decode_flops(res.dims, n) for rows in steps for n in rows)
    return 100.0 * flops / (v["window_s"] * peaks.BF16_FLOPS)
