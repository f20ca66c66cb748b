"""The synthetic token pipeline, twin of `repro.data` (`pipeline`)."""
