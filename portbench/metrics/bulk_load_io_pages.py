def read(run):
    return run.io_pages
