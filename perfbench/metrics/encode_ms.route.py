"""encode_ms.route: the mean host time of the engine's query encoding
(``ShardedRoutingEngine.encode``: tokens, intent, term counts) over the
window's batches, from the benchmark's own span around each call, in ms
(a traced run's window calls ``encode`` and ``route``, the two calls
``route_texts`` makes, and profiles only after the window)."""


def read(res):
    spans = res.spans.get("encode")
    return 1e3 * sum(spans) / len(spans) if spans else None
