"""The LLM scaffold's models, twin of `repro.models` (dense GQA decoders)."""
