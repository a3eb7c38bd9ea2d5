"""Named resolutions, the training scale pairs and the model's upscale
factors.

Same values as the JAX package's resolutions.py (reference
tools/utils.py:25-34, data_handling/data_class.py:34-45); the port keeps
its own copy.
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

# The ten LR -> HR geometry pairs every dataset sample expands into.
SCALE_PAIRS = (
    {"lr": (720, 1280), "hr": (1080, 1920)},
    {"lr": (720, 1280), "hr": (1440, 2560)},
    {"lr": (1080, 1920), "hr": (1440, 2560)},
    {"lr": (720, 1280), "hr": (2160, 3840)},
    {"lr": (1080, 1920), "hr": (2160, 3840)},
    {"lr": (1440, 2560), "hr": (2160, 3840)},
    {"lr": (96, 96), "hr": (192, 192)},
    {"lr": (96, 96), "hr": (288, 288)},
    {"lr": (96, 96), "hr": (384, 384)},
    {"lr": (96, 96), "hr": (576, 576)},
)

VALID_SCALES = (2, 3, 4, 6)
