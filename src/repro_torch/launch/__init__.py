"""Entry points of the port, twin of `repro.launch`: `serve` (the SONAR
gateway in front of a replica fleet, ``--mode sync`` or ``--mode online``)
and `train` (the fault-tolerant training driver).
"""
