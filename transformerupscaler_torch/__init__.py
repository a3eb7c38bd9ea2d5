"""PyTorch/CUDA port of transformerupscaler_tpu for one NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it,
nor JAX, and importing it builds no kernel. Entry points: ``get_model``
(``registry.get_model``; ``registry.register_model`` adds a model) and
``infer_lib.UpscalerEngine``; both run on the card unless the caller passes
``device="cpu"``. ``list_models()`` names the registered models,
``resolutions`` the named output sizes.
"""

__version__ = "0.1.0"

from transformerupscaler_torch.resolutions import resolutions  # noqa: F401
from transformerupscaler_torch.registry import get_model, list_models  # noqa: F401
