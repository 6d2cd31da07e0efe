from portbench import trace


def read(run):
    if run.trace is None or not run.traced_requests:
        return None
    return trace.op_count(run.trace, "Memcpy DtoH") / run.traced_requests
