"""Routing core of the port: dataset, BM25, QoS, scalar and batched routers."""
