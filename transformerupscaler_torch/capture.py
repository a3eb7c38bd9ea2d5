"""Cross-platform window enumeration, selection and capture for the live
overlay frontends (``transformerupscaler_torch.overlay``,
``transformerupscaler_torch.app_overlay``).

The port's own copy of transformerupscaler_tpu/capture.py, host-only and
unchanged in function: macOS Quartz window listing, bounds and content
capture with the AppKit click-through overlay, Windows pygetwindow
selection with PIL.ImageGrab capture, and the Linux mss region capture.

Every OS dependency (Quartz, AppKit, pygetwindow, PIL.ImageGrab, mss) is
imported lazily inside the backend that needs it, so this module imports
on any host and each backend fails with a clear error where its package is
missing. Backends share one small interface, which is also the test seam:
tests drive ``select_window`` and the overlay loop with a fake backend.
"""

from __future__ import annotations

import platform
from dataclasses import dataclass, field

import numpy as np


@dataclass
class WindowInfo:
    """One capturable window. ``handle`` is backend-private (Quartz dict,
    pygetwindow object, mss monitor dict, ...)."""

    title: str
    left: int
    top: int
    width: int
    height: int
    handle: object = field(default=None, repr=False)

    @property
    def bounds(self) -> tuple[int, int, int, int]:
        return self.left, self.top, self.width, self.height


class CaptureBackend:
    """Interface: list windows, capture one, refresh its position."""

    name = "abstract"

    def list_windows(self) -> list[WindowInfo]:
        raise NotImplementedError

    def capture(self, window: WindowInfo) -> np.ndarray:
        """HWC uint8 RGB frame of the window's current content."""
        raise NotImplementedError

    def refresh_bounds(self, window: WindowInfo) -> WindowInfo:
        """Re-query the window's position (used to track a moving window,
        reference app_overlay.py:405-406). Default: unchanged."""
        return window

    def make_click_through(self, overlay_title: str) -> bool:
        """Make the overlay window ignore mouse events where the OS supports
        it (reference :159-169). Returns True on success."""
        return False


class MacQuartzBackend(CaptureBackend):
    """Quartz window list/capture + AppKit click-through (reference
    app_overlay.py:106-169)."""

    name = "quartz"

    def __init__(self):
        import Quartz  # noqa: F401 — fail fast if unavailable

        self._quartz = Quartz

    def list_windows(self) -> list[WindowInfo]:
        Q = self._quartz
        infos = Q.CGWindowListCopyWindowInfo(
            Q.kCGWindowListOptionOnScreenOnly, Q.kCGNullWindowID)
        out = []
        for w in infos:
            title = (w.get("kCGWindowName") or "").strip()
            if not title:
                continue
            b = w.get("kCGWindowBounds", {})
            out.append(WindowInfo(
                title=title,
                left=int(b.get("X", 0)), top=int(b.get("Y", 0)),
                width=int(b.get("Width", 0)), height=int(b.get("Height", 0)),
                handle=w))
        return out

    def capture(self, window: WindowInfo) -> np.ndarray | None:
        Q = self._quartz
        w = window.handle
        b = w.get("kCGWindowBounds", {})
        rect = Q.CGRectMake(float(b.get("X", 0)), float(b.get("Y", 0)),
                            float(b.get("Width", 0)), float(b.get("Height", 0)))
        img = Q.CGWindowListCreateImage(
            rect, Q.kCGWindowListOptionIncludingWindow,
            w.get("kCGWindowNumber"), Q.kCGWindowImageDefault)
        if img is None:
            return None
        width, height = Q.CGImageGetWidth(img), Q.CGImageGetHeight(img)
        stride = Q.CGImageGetBytesPerRow(img)
        data = Q.CGDataProviderCopyData(Q.CGImageGetDataProvider(img))
        buf = np.frombuffer(data, np.uint8).reshape(height, stride // 4, 4)
        return np.ascontiguousarray(buf[:, :width, :3])  # RGBA -> RGB

    def make_click_through(self, overlay_title: str) -> bool:
        from AppKit import NSApplication

        app = NSApplication.sharedApplication()
        for win in app.windows():
            if overlay_title in str(win.title()):
                win.setIgnoresMouseEvents_(True)
                return True
        return False


class WindowsBackend(CaptureBackend):
    """pygetwindow enumeration + PIL.ImageGrab capture (reference
    app_overlay.py:171-203)."""

    name = "pygetwindow"

    def __init__(self):
        import pygetwindow as gw

        self._gw = gw

    def list_windows(self) -> list[WindowInfo]:
        out = []
        for title in self._gw.getAllTitles():
            if not title.strip():
                continue
            wins = self._gw.getWindowsWithTitle(title)
            if not wins:
                continue
            w = wins[0]
            out.append(WindowInfo(title=title, left=w.left, top=w.top,
                                  width=w.width, height=w.height, handle=w))
        return out

    def capture(self, window: WindowInfo) -> np.ndarray:
        from PIL import ImageGrab

        w = window.handle
        bbox = (w.left, w.top, w.left + w.width, w.top + w.height)
        return np.asarray(ImageGrab.grab(bbox).convert("RGB"))

    def refresh_bounds(self, window: WindowInfo) -> WindowInfo:
        w = window.handle
        return WindowInfo(window.title, w.left, w.top, w.width, w.height, w)


class LinuxMssBackend(CaptureBackend):
    """mss screen-region capture (reference app_overlay.py:205-209). X11
    exposes no portable window list, so windows are named screen regions:
    the full virtual screen plus each monitor."""

    name = "mss"

    def __init__(self):
        import mss

        self._sct = mss.mss()

    def list_windows(self) -> list[WindowInfo]:
        out = []
        for i, mon in enumerate(self._sct.monitors):
            title = "Entire screen" if i == 0 else f"Monitor {i}"
            out.append(WindowInfo(
                title=title, left=mon["left"], top=mon["top"],
                width=mon["width"], height=mon["height"], handle=dict(mon)))
        return out

    def capture(self, window: WindowInfo) -> np.ndarray:
        shot = self._sct.grab(window.handle)
        return np.asarray(shot)[:, :, :3][:, :, ::-1]  # BGRA -> RGB

    @staticmethod
    def region(left: int, top: int, width: int, height: int) -> WindowInfo:
        mon = {"left": left, "top": top, "width": width, "height": height}
        return WindowInfo(f"Region {width}x{height}+{left}+{top}",
                          left, top, width, height, handle=mon)


def pick_backend(system: str | None = None) -> CaptureBackend:
    """Platform -> backend, same mapping as the reference (Darwin -> Quartz,
    Windows -> pygetwindow, else mss; app_overlay.py:217-235)."""
    system = system or platform.system()
    if system == "Darwin":
        return MacQuartzBackend()
    if system == "Windows":
        return WindowsBackend()
    return LinuxMssBackend()


def select_window(backend: CaptureBackend, chooser=None) -> WindowInfo:
    """Print the window list and let the user pick one (reference
    :116-126, :171-181). ``chooser`` (index-returning callable) is the test
    seam replacing ``input``."""
    windows = backend.list_windows()
    if not windows:
        raise RuntimeError(f"No capturable windows found ({backend.name}).")
    print("Available windows:")
    for i, w in enumerate(windows, start=1):
        print(f"{i}: {w.title}")
    if chooser is None:
        chooser = lambda n: int(input("Enter the number of the window to capture: "))  # noqa: E731
    idx = int(chooser(len(windows)))
    if not 1 <= idx <= len(windows):
        raise ValueError(f"Window index {idx} out of range 1..{len(windows)}")
    return windows[idx - 1]
