def read(run):
    if not run.spans or not run.requests:
        return None
    return run.spans["engine"] / run.requests * 1e3
