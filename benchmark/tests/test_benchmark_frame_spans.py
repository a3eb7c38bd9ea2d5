"""The four readings of the program's per-frame spans (``held_ms``,
``dispatch_ms``, ``copy_out_ms``, ``device_ms``) and the frame's chained
segments (``lib/frames.py``) on a synthetic record: the readings by hand,
None where the record has no spans (a program without the trace) or lacks
the device's."""

from __future__ import annotations

import pytest
from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)

from benchmark.lib.frames import CHAIN, READINGS, chain_ms, mean_ms


def _frame(t0: float) -> dict:
    """A frame due at t0 (seconds); its spans as the pipeline orders them:
    pulled 0.1 ms late, preprocessed, held a period, dispatched 1 ms, on the
    card 4 ms from its copy in, held, fetched (0.5 ms wait, 6 ms copy),
    sunk."""
    ms = 1e-3
    return {
        "pipeline.pull": (t0 - 5 * ms, t0 + 0.1 * ms),
        "pipeline.preprocess": (t0 + 0.2 * ms, t0 + 0.3 * ms),
        "pipeline.dispatch": (t0 + 16.9 * ms, t0 + 17.9 * ms),
        "pipeline.enqueue": (t0 + 17.5 * ms, t0 + 17.9 * ms),
        "device.copy_in": (t0 + 17.6 * ms, t0 + 18.0 * ms),
        "device.graph": (t0 + 18.0 * ms, t0 + 21.0 * ms),
        "device.copy_out": (t0 + 21.0 * ms, t0 + 21.6 * ms),
        "pipeline.fetch": (t0 + 35.0 * ms, t0 + 41.6 * ms),
        "pipeline.fetch_wait": (t0 + 35.01 * ms, t0 + 35.51 * ms),
        "pipeline.copy_out": (t0 + 35.52 * ms, t0 + 41.52 * ms),
        "pipeline.sink": (t0 + 41.62 * ms, t0 + 41.7 * ms),
    }


def _read(name: str, rec: dict):
    return mean_ms(rec, READINGS[name])


def test_readings_on_a_synthetic_record():
    rec = {"frame_spans": [_frame(100.0), _frame(100.0 + 1 / 60)]}
    got = {name: _read(name, rec) for name in READINGS}
    assert got["held_ms"] == pytest.approx(16.6 + 13.4)
    assert got["dispatch_ms"] == pytest.approx(1.0)
    assert got["copy_out_ms"] == pytest.approx(6.0)
    assert got["device_ms"] == pytest.approx(4.0)


@pytest.mark.parametrize("name", READINGS)
def test_readings_give_none_without_spans(name):
    assert _read(name, {}) is None
    assert _read(name, {"frame_spans": []}) is None


def test_device_readings_give_none_without_device_spans():
    host_only = {k: v for k, v in _frame(5.0).items()
                 if not k.startswith("device.")}
    rec = {"frame_spans": [host_only]}
    assert _read("held_ms", rec) is None
    assert _read("device_ms", rec) is None
    assert _read("dispatch_ms", rec) == pytest.approx(1.0)


def test_the_chain_covers_the_latency():
    f, due = _frame(7.0), 7.0
    c = chain_ms(f, due, arrival=due + 41.625e-3)
    assert list(c) == [*CHAIN, "unaccounted"]
    assert c["held"] == pytest.approx(30.0)
    assert c["device after dispatch"] == pytest.approx(21.6 - 17.9)
    # The fetch's own gaps (0.01, 0.01, 0.08 ms) and the step to the
    # sink (0.02 ms).
    assert c["unaccounted"] == pytest.approx(0.12, abs=1e-6)
    # A fetch that waits for the card: the rest of the device's time is
    # its wait, and the chain still covers the latency.
    late = dict(f, **{"device.copy_out": (7.021, 7.0352)})
    c = chain_ms(late, due, arrival=due + 41.625e-3)
    assert c["device after dispatch"] == pytest.approx(35.0 - 17.9)
    assert c["unaccounted"] == pytest.approx(0.12, abs=1e-6)
    # A host that stalls in its dispatch after the card finished the frame:
    # held from the dispatch's end, nothing counted twice.
    stalled = dict(f, **{"pipeline.dispatch": (7.0169, 7.0229)})
    c = chain_ms(stalled, due, arrival=due + 41.625e-3)
    assert c["device after dispatch"] == 0.0
    assert c["held"] == pytest.approx(16.6 + 35.0 - 22.9)
    assert c["unaccounted"] == pytest.approx(0.12, abs=1e-6)
