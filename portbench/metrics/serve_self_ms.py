"""The server's own host time per request: its span less the engine's."""


def read(run):
    if not run.spans or not run.requests:
        return None
    return (run.spans["server"] - run.spans["engine"]) / run.requests * 1e3
