"""Layer math and initialisers, twin of `repro.nn`."""
