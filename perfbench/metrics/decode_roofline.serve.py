"""decode_roofline.serve: the decode attention kernel's share of its
roofline over the traced stretch, in %: the least time the card could
take to read each decoded slot's own valid cache rows, query and output
(perfbench/counts/lm.py, over HBM bandwidth) over the device time of the
decode kernels (``decode_split_kernel``, ``decode_merge_kernel``) in the
profiler's trace."""
from perfbench.counts import lm, peaks


def read(res):
    if res.trace is None:
        return None
    sec, count = res.trace.op_seconds("decode_split_kernel", "decode_merge_kernel")
    steps = res.trace_work.get("decode_rows") or []
    if not count or not any(steps):
        return None
    least = sum(lm.decode_attn_bytes(res.dims, n) for rows in steps for n in rows)
    return 100.0 * least / peaks.HBM_BYTES_PER_S / sec
