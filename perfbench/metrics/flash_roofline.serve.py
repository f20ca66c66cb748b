"""flash_roofline.serve: the prefill attention kernel's share of its
roofline over the traced stretch, in %: the least time the card could
take for the causal attention of every prompt prefilled there (operations
over the bf16 peak, or bytes over HBM bandwidth, the larger;
perfbench/counts/lm.py) over the device time of the flash kernels
(``flash_wgmma_kernel``, ``flash_kernel``) in the profiler's trace."""
from perfbench.counts import lm, peaks


def read(res):
    if res.trace is None:
        return None
    sec, count = res.trace.op_seconds("flash_wgmma_kernel", "flash_kernel")
    lengths = res.trace_work.get("prefill_lengths") or []
    if not count or not lengths:
        return None
    least = sum(max(lm.flash_prefill_flops(res.dims, s) / peaks.BF16_FLOPS,
                    lm.flash_prefill_bytes(res.dims, s) / peaks.HBM_BYTES_PER_S)
                for s in lengths)
    return 100.0 * least / sec
