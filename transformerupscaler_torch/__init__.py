"""PyTorch/CUDA port of transformerupscaler_tpu for one NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it,
nor JAX. Entry points: ``registry.get_model`` and
``infer_lib.UpscalerEngine``; both run on the card unless the caller passes
``device="cpu"``.
"""
