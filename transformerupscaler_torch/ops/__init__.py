"""Plain PyTorch ops of the port (NHWC); the names JAX's
``transformerupscaler_tpu.ops`` exports."""

from transformerupscaler_torch.ops.resize import (  # noqa: F401
    resize,
    interpolate_bicubic,
    resize_antialias_bilinear,
    resize_matrix,
)
from transformerupscaler_torch.ops.windows import (  # noqa: F401
    window_partition,
    window_reverse,
)
from transformerupscaler_torch.ops.pixel_shuffle import pixel_shuffle  # noqa: F401
from transformerupscaler_torch.ops.patch import (  # noqa: F401
    patch_embed,
    patch_unembed,
)
from transformerupscaler_torch.ops.relpos import relative_position_index  # noqa: F401
