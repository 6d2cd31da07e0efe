"""Share of the window engine's page-locked answer hand-offs that landed
in a block it had handed out before (a recycled block, not a new
``cudaHostAlloc``), in %, from the engine's own counters
(``repro_torch.tracing``): every window batch the run's process served,
warm-up, window and traced slice alike.  None where the program has no
such counters or no hand-off landed in page-locked memory (a CPU run)."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    pinned = c.get("engine.answers_pinned", 0)
    return 100.0 * (1 - c.get("engine.answers_fresh_blocks", 0) / pinned) if pinned else None
