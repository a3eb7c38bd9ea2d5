"""What the kernel wrappers share: the launch counters and the checks a
wrapper makes before it hands pointers to a CUDA kernel."""

from __future__ import annotations

import torch

# Wrapper name -> launches of its CUDA kernel since the last reset. A wrapper
# adds one where it launches its kernel and nowhere else.
LAUNCHES = dict.fromkeys(
    ("conv3x3_stream", "tail_conv_stream", "embed_stream",
     "unembed_combine_stream", "fused_window_trunk", "tail_finish_stream",
     "window_attention_core", "global_mha", "conv3x3_int8_stream",
     "tail_conv_int8_stream", "conv1_stream", "conv3x3_tail_stream",
     "conv3x3_tail_emit_stream"), 0)
# The same for the wrappers of the JAX package's archived kernels, which no
# model reaches (its tests and probes call them): the general NHWC 3x3 conv
# and the patch embed / unembed + add with their own rounding points.
ARCHIVED_LAUNCHES = dict.fromkeys(
    ("conv3x3", "fused_patch_embed", "fused_patch_unembed_add"), 0)


# The fused trunk's kernel modes, in the order of the kernel's mode argument,
# and its launches by mode (each also counts under "fused_window_trunk").
TRUNK_MODES = ("v2", "v1", "int8_rowwise", "int8_static")
MODE_LAUNCHES = dict.fromkeys(TRUNK_MODES, 0)
# Launches with an int8 option, by ``<wrapper>.<option>`` (each also counts
# under its wrapper's name): the conv's int8 output (``out_scale``), the
# embed's int8 input (``in_scale``), the unembed's int8 skip
# (``feat_scale``).
OPTION_LAUNCHES = dict.fromkeys(
    ("conv3x3_stream.int8_out", "embed_stream.int8_in",
     "unembed_combine_stream.int8_skip"), 0)


def reset_launches() -> None:
    for counts in (LAUNCHES, ARCHIVED_LAUNCHES, MODE_LAUNCHES,
                   OPTION_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _counters():
    """(name as ``launch_counts`` gives it, its dict, its key there) of
    every counter."""
    for counts in (LAUNCHES, ARCHIVED_LAUNCHES, OPTION_LAUNCHES):
        for k in counts:
            yield k, counts, k
    for m in MODE_LAUNCHES:
        yield f"fused_window_trunk.{m}", MODE_LAUNCHES, m


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta``, keyed as ``launch_counts`` keys it, to the counters:
    a CUDA graph's replay launches again what its capture counted."""
    for name, counts, k in _counters():
        counts[k] += delta.get(name, 0)


def launch_counts() -> dict[str, int]:
    """Every counter in one flat dict: the wrappers' (the archived ones
    too), the trunk's by mode as ``fused_window_trunk.<mode>``, and the
    int8 options'."""
    return {**LAUNCHES, **ARCHIVED_LAUNCHES,
            **{f"fused_window_trunk.{m}": n for m, n in MODE_LAUNCHES.items()},
            **OPTION_LAUNCHES}


def on_card(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors (kernel);
    raises on anything else or on a mix. None entries are skipped. A CUDA
    tensor that requires grad while autograd records raises too: the
    kernels have no backward, and launching one would detach the result
    from the graph without a word."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError("a CUDA kernel of the port got a tensor that "
                           "requires grad: the kernels have no backward "
                           "(train mode runs the plain PyTorch path)")
    return True


def check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def raise_on(err: int, fn: str) -> None:
    if err:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
