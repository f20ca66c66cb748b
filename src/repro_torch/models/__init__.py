"""The LLM scaffold's models, twin of `repro.models` (attention decoders
with dense or MoE FFNs)."""
