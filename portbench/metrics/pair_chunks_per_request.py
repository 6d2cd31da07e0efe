"""Pair chunks a window request, from the engine's own counters
(``repro_torch.tracing``): every window batch the run's process served,
warm-up, window and traced slice alike, since the counters run from the
process's start (one batch a request in these cells).  None where the
program has no such counters."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    batches = c.get("engine.window_batches", 0)
    return c.get("engine.pair_chunks", 0) / batches if batches else None
