"""The fused window trunk (``kernels/trunk2.fused_window_trunk``,
``csrc/window_trunk.cu``): every window block of the model over the padded
window grid in one launch."""

PATTERN = r"\bwindow_trunk_kernel\b"


def work(shape) -> tuple[float, float]:
    """(operations, bytes) of one launch over ``shape`` = (windows, tokens a
    window, dim, layers, heads): the four GEMMs (12 dim^2 multiply-adds a
    token) and the two attention products (2 tokens dim a token) in every
    layer; the windows read and written in bf16, the GEMM weights in bf16,
    the layer's vectors (two LayerNorms' scale and shift, four biases: 13
    dim) and its relative-bias table ((2 ws - 1)^2 heads) in float32. The
    tokens are those of the padded grid, the padding included."""
    windows, tokens, dim, layers, heads = shape
    n = windows * tokens
    ws = round(tokens ** 0.5)
    flops = layers * n * (2.0 * 12 * dim * dim + 2.0 * 2 * tokens * dim)
    n_bytes = (2 * n * dim * 2
               + layers * (12 * dim * dim * 2 + 13 * dim * 4
                           + (2 * ws - 1) ** 2 * heads * 4))
    return flops, n_bytes
