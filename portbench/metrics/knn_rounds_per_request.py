"""k-NN rounds a request (the first and each rerun of the queries whose
certificate failed), from the engine's own counters
(``repro_torch.tracing``): every k-NN batch the run's process served,
warm-up, window and traced slice alike, since the counters run from the
process's start (one batch a request in these cells).  None where the
program has no such counters."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    batches = c.get("engine.knn_batches", 0)
    return c.get("engine.knn_rounds", 0) / batches if batches else None
