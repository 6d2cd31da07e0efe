def read(run):
    if run.device_bytes is None:
        return None
    return run.device_bytes / run.n_points
