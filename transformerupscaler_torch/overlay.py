"""Simple live overlay (JAX counterpart: the root overlay.py).

    python -m transformerupscaler_torch.overlay [--model FastTransformer]

mss captures the 720p screen region at the top left, the pipeline upscales
it to 1080p on the card (``--device cpu`` without one), and an OpenCV
window on top shows it with an FPS counter. Needs ``cv2`` and ``mss`` on
the host, imported when it runs; headless hosts run
``python -m transformerupscaler_torch.stream``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from transformerupscaler_torch.stream_lib import StreamPipeline


def main(args):
    try:
        import cv2
        import mss
    except ImportError as e:
        raise SystemExit(
            f"cv2/mss not installed ({e}) — use `python -m "
            f"transformerupscaler_torch.stream` for the headless pipeline.")

    res_in, res_out = (720, 1280), (1080, 1920)
    # bgr_out: the RGB -> BGR swap for cv2 runs in the device step.
    pipe = StreamPipeline(args.model, res_in, res_out,
                          checkpoint_dir=args.checkpoint_dir, bgr_out=True,
                          device=args.device)
    print(f"checkpoint loaded: {pipe.from_checkpoint}")
    print(f"compiled in {pipe.warmup():.1f}s")

    sct = mss.mss()
    region = {"left": 0, "top": 0, "width": res_in[1], "height": res_in[0]}

    window = "Upscaled"
    cv2.namedWindow(window, cv2.WINDOW_NORMAL)
    cv2.setWindowProperty(window, cv2.WND_PROP_TOPMOST, 1)

    def source():
        while True:
            yield np.asarray(sct.grab(region))[:, :, :3][:, :, ::-1]

    last = [time.time()]

    def sink(out_bgr):
        bgr = np.ascontiguousarray(out_bgr)
        fps = 1.0 / max(time.time() - last[0], 1e-6)
        last[0] = time.time()
        cv2.putText(bgr, f"FPS: {fps:.2f}", (10, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 255, 0), 2)
        cv2.imshow(window, bgr)
        if cv2.waitKey(1) & 0xFF == ord("q"):
            raise KeyboardInterrupt

    try:
        pipe.run(source(), sink=sink)
    except KeyboardInterrupt:
        pass
    finally:
        cv2.destroyAllWindows()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Simple live overlay upscaler")
    parser.add_argument("--model", type=str, default="FastTransformer")
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the card")
    main(parser.parse_args())
