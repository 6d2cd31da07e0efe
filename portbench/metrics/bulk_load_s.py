def read(run):
    return run.setup["bulk_load_s"]
