"""Live window-capture overlay (JAX counterpart: the root app_overlay.py).

    python -m transformerupscaler_torch.app_overlay [--fast] [--region L,T,W,H]

Select a window (macOS Quartz, Windows pygetwindow, Linux mss screen
regions: ``capture``), capture it in a latest-frame-wins thread
(``FrameGrabber``), upscale it with ``stream_lib.StreamPipeline`` on the
card (``--device cpu`` without one; the RGB -> BGR swap in the device
step), and show it in a topmost, click-through OpenCV window that follows
the captured window every 50 frames, with an FPS counter; Ctrl-C prints the
per-stage timing report. ``cv2`` and the capture backends are imported when
used; headless hosts run ``python -m transformerupscaler_torch.stream``.

``--fast`` / ``--quality`` on the card serve the stream kernels with the
fused trunk (``pallas_serve=True, attn_impl="fused2"``), the counterpart of
the JAX app's choice on a TPU (app_overlay.py:104-113); with
``--device cpu`` the all-XLA packed path with ``attn_impl="xla"``.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from transformerupscaler_torch.capture import (
    LinuxMssBackend,
    pick_backend,
    select_window,
)
from transformerupscaler_torch.cli import on_card, serve_flags
from transformerupscaler_torch.resolutions import resolutions
from transformerupscaler_torch.stream_lib import StreamPipeline


def _cv2():
    """OpenCV, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


class FrameGrabber:
    """Latest-frame-wins capture thread (JAX app_overlay.py:42-72)."""

    def __init__(self, capture_func):
        self.capture_func = capture_func
        self.frame = None
        self.lock = threading.Lock()
        self.stopped = False
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def _loop(self):
        while not self.stopped:
            frame = self.capture_func()
            if frame is not None:
                with self.lock:
                    self.frame = frame

    def read(self):
        with self.lock:
            return self.frame

    def stop(self):
        self.stopped = True


def run_overlay(args, backend=None, pipe=None, chooser=None, imshow=None,
                max_frames=None):
    """The overlay loop (JAX app_overlay.py:74-178), every host dependency
    injectable for tests: ``backend`` (capture), ``pipe`` (the pipeline),
    ``chooser`` (window selection), ``imshow`` (display; returns False to
    stop). Returns the pipeline."""
    cv2 = _cv2()
    if backend is None:
        try:
            backend = pick_backend()
        except ImportError as e:
            raise SystemExit(
                f"Screen capture is unavailable in this environment ({e}). "
                "Use `python -m transformerupscaler_torch.stream` for the "
                "headless pipeline with the same per-stage timing report.")

    if args.region:
        left, top, width, height = (int(v) for v in args.region.split(","))
        target = LinuxMssBackend.region(left, top, width, height)
        if not isinstance(backend, LinuxMssBackend):
            backend = LinuxMssBackend()
    else:
        target = select_window(backend, chooser=chooser)
        print(f"Selected window: {target.title}")
    left, top, width, height = target.bounds
    print(f"Using bounding box: left={left}, top={top}, "
          f"width={width}, height={height}")

    res_in = resolutions[args.res_in] if args.res_in else (720, 1280)
    res_out = resolutions[args.res_out]

    if pipe is None:
        # getattr keeps Namespaces without the newer flags working.
        device = getattr(args, "device", None)
        pipe = StreamPipeline(args.model, res_in, res_out,
                              checkpoint_dir=args.checkpoint_dir,
                              quantize=args.quantize, bgr_out=True,
                              device=device, **serve_flags(
                                  getattr(args, "fast", False),
                                  getattr(args, "quality", False),
                                  card=on_card(device)))
        print(f"checkpoint loaded: {pipe.from_checkpoint}")
        print(f"compiled in {pipe.warmup():.1f}s")

    grabber = FrameGrabber(lambda: backend.capture(target)).start()

    window_name = "Overlay Upscaled"
    own_window = imshow is None
    if own_window:
        if cv2 is None:
            raise SystemExit(
                "OpenCV is not installed — the overlay window is unavailable "
                "in this environment. Use `python -m "
                "transformerupscaler_torch.stream` for the headless pipeline.")
        cv2.namedWindow(window_name, cv2.WINDOW_NORMAL)
        cv2.setWindowProperty(window_name, cv2.WND_PROP_TOPMOST, 1)
        time.sleep(0.5)
        if backend.make_click_through(window_name):
            print(f"Overlay window '{window_name}' is click-through.")

        def imshow(frame):
            cv2.imshow(window_name, frame)
            return (cv2.waitKey(1) & 0xFF) != ord("q")

    overlay_buf = np.empty((height, width, 3), np.uint8)
    state = {"last": time.time(), "iters": 0, "target": target}
    move_window_interval = 50

    def source():
        while True:
            frame = grabber.read()
            if frame is None:
                time.sleep(0.005)
                continue
            yield frame

    def sink(out_bgr):
        # Follow the captured window.
        state["iters"] += 1
        if state["iters"] % move_window_interval == 0:
            state["target"] = backend.refresh_bounds(state["target"])
            if own_window:
                cv2.moveWindow(window_name, state["target"].left,
                               state["target"].top)
        if cv2 is not None and out_bgr.shape[:2] != (height, width):
            cv2.resize(out_bgr, (width, height), dst=overlay_buf)
            frame = overlay_buf
        else:
            frame = np.ascontiguousarray(out_bgr)
        # The FPS is drawn on the frame that is shown.
        now = time.time()
        fps = 1.0 / max(now - state["last"], 1e-6)
        state["last"] = now
        if cv2 is not None:
            cv2.putText(frame, f"FPS: {fps:.2f}", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 255, 0), 2)
        if not imshow(frame):
            raise KeyboardInterrupt

    try:
        pipe.run(source(), sink=sink, max_frames=max_frames)
    except KeyboardInterrupt:
        print("\nKeyboardInterrupt caught. Profiling results:")
        print(pipe.timer.report())
    finally:
        grabber.stop()
        if own_window:
            cv2.destroyAllWindows()
    return pipe


def main(args):
    if _cv2() is None:
        raise SystemExit(
            "OpenCV is not installed — the overlay window is unavailable in "
            "this environment. Use `python -m transformerupscaler_torch."
            "stream` for the headless pipeline with the same per-stage "
            "timing report.")
    run_overlay(args)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Overlay App for the Transformer Upscaler on the GPU")
    p.add_argument("--model", type=str, default="FastTransformer",
                   help="Model name from the registry")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="Checkpoint dir (default models/{model}/checkpoints)")
    p.add_argument("--res_out", type=str, default="4k",
                   help="Output resolution key")
    p.add_argument("--res_in", type=str, default=None,
                   help="Input resolution key (None for 720p)")
    p.add_argument("--region", type=str, default=None,
                   help="Capture a fixed region 'left,top,width,height' "
                        "instead of selecting a window")
    p.add_argument("--compile", action="store_true",
                   help="Accepted for reference-CLI parity; the step is "
                        "always one CUDA graph on the card")
    p.add_argument("--quantize", action="store_true",
                   help="Enable int8 quantization of linear layers")
    p.add_argument("--fast", action="store_true",
                   help="serving fast path (composed tails; on the card the "
                        "stream kernels and the fused trunk)")
    p.add_argument("--quality", action="store_true",
                   help="serve_quality mode of the fast path (f32 image "
                        "boundaries)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
