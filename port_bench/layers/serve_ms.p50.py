"""serve_ms.p50: the median wall milliseconds of a TMService.serve call,
its wait on the device lock included."""
import statistics


def read(run):
    return (statistics.median(run.serve_call_ms) if run.serve_call_ms
            else None)
