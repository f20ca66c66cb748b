"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity), the yardstick of every roofline and mfu metric.
They assume the card's full 700 W; each run prints ``nvidia-smi``'s power
limit beside its result (`perfbench.harness.core.card_note`)."""

BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores
F32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
