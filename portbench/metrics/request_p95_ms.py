import statistics


def read(run):
    if len(run.latencies) < 20:
        return None
    return statistics.quantiles(run.latencies, n=100, method="inclusive")[94] * 1e3
