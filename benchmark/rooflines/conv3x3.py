"""The stream 3x3 conv (``kernels/stream.conv3x3_stream``,
``csrc/conv3x3.cu``): a 3x3 conv with bias and ReLU, NHWC bf16."""

PATTERN = r"\bconv3x3_kernel\b"


def work(shape) -> tuple[float, float]:
    """(operations, bytes) of one launch over ``shape`` = (h, w, cin, cout):
    9 cin cout multiply-adds a pixel; the map read and the map written in
    bf16, the weights in bf16, the bias in float32."""
    h, w, cin, cout = shape
    flops = 2.0 * h * w * 9 * cin * cout
    n_bytes = h * w * (cin + cout) * 2 + 9 * cin * cout * 2 + cout * 4
    return flops, n_bytes
