"""Open loop: frame j of the ring is due at t0 + j / rate whether or not
the pipeline kept up (a live overlay at the display's rate: ``overlay``,
``app_overlay``)."""

from benchmark.lib.stream import run_stream


def run(run) -> dict:
    return run_stream(run, open_loop=True)
