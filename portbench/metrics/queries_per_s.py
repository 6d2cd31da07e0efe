def read(run):
    return run.queries / run.window_s if run.window_s > 0 else None
