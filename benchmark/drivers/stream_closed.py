"""Closed loop: ``StreamPipeline.run`` pulls the ring's frames as fast as
it takes them (a video or still-image job: ``stream``, ``speed_test``)."""

from benchmark.lib.stream import run_stream


def run(run) -> dict:
    return run_stream(run, open_loop=False)
