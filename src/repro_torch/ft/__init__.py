"""Fault tolerance, twin of `repro.ft`: step checkpoints (`checkpoint`) and
the fleet monitor, elastic plan and failure injector (`failure`)."""
