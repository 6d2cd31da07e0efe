def read(run):
    return run.setup["export_s"]
