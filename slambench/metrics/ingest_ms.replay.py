"""Host ms a frame spends in ingest (`build_range_image`, `host_cloud`), traced run's spans."""

from slambench import readers


def read(run):
    return readers.span_ms_per_frame(run, "ingest")
