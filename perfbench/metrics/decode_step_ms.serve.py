"""decode_step_ms.serve: the mean host time of the window's engine steps
that admitted nothing (one decode of every slot, ending in the engine's
own host read of the tokens), from the benchmark's span around
``ServeEngine.step``, in ms."""


def read(res):
    steps = res.spans.get("decode_step")
    return 1e3 * sum(steps) / len(steps) if steps else None
