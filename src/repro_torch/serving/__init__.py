"""Serving, twin of `repro.serving`: the slot-based `ServeEngine`.

The gateway, micro-batcher and asyncio front end are `ROADMAP.md` queue 1,
item 7.
"""
