"""Named resolutions and the model's upscale factors.

Same values as the JAX package's resolutions.py (reference
tools/utils.py:25-34); the port keeps its own copy.
"""

resolutions = {
    "350": (350, 630),
    "360": (360, 640),
    "720": (720, 1280),
    "1080": (1080, 1920),
    "1440": (1440, 2560),
    "2k": (1440, 2560),
    "2160": (2160, 3840),
    "4k": (2160, 3840),
}

VALID_SCALES = (2, 3, 4, 6)
