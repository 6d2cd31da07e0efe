def read(run):
    if run.trace is None or not run.traced_requests:
        return None
    return run.trace["busy_s"] / run.traced_requests * 1e3
