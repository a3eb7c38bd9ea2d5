"""Multi-scale sub-pixel Upsampler: its forward and the composition of its
stages into one base-resolution tail conv.

JAX counterpart: transformerupscaler_tpu models/upsampler.py:32-129 (the
parameter bank for every scale and ``Upsampler.__call__``), :132-203
(``split_tail_kernels``) and :206-279 (``composed_tail_kernel``).
FastTransformer's exact path runs ``Upsampler.forward``, stage by stage in
plain PyTorch on ``ops.conv.conv2d``; the serving path never does: each
branch tail is folded at base resolution into a single k x k conv, or for
branch B into a mid conv and a small finish conv, whose outputs are
``pixel_shuffle(scale)``-ordered channels.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn

from transformerupscaler_torch.models.common import param
from transformerupscaler_torch.ops.conv import compose_conv3x3_kernels, conv2d
from transformerupscaler_torch.ops.pixel_shuffle import (
    commute_conv_through_shuffle,
    pixel_shuffle,
)
from transformerupscaler_torch.resolutions import VALID_SCALES

# scale -> list of (channel multiplier, shuffle factor) stages
STAGES = {2: [(4, 2)], 3: [(9, 3)], 4: [(4, 2), (4, 2)], 6: [(36, 6)]}


class Upsampler(nn.Module):
    """The conv + shuffle stages of every scale: parameters
    ``s{scale}_c{i}_kernel`` (3, 3, n, mult*n) HWIO and ``s{scale}_c{i}_bias``."""

    def __init__(self, n_feats: int):
        super().__init__()
        for scale in VALID_SCALES:
            for i, (mult, _) in enumerate(STAGES[scale]):
                self.register_parameter(f"s{scale}_c{i}_kernel",
                                        param(3, 3, n_feats, mult * n_feats))
                self.register_parameter(f"s{scale}_c{i}_bias",
                                        param(mult * n_feats))

    def stage_params(self) -> dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def forward(self, x: torch.Tensor, scale: int, tail_kernel=None,
                tail_bias=None, tail_relu: bool = False,
                compose_tail: bool = False, return_preshuffle: bool = False,
                pre_kernel=None, pre_bias=None) -> torch.Tensor:
        """Upsample NHWC ``x`` by ``scale``: each stage a 3x3 conv, then its
        pixel shuffle (JAX ``Upsampler.__call__``, upsampler.py:48-125).

        ``tail_kernel`` / ``tail_bias``: the 3x3 conv that follows the
        upsample, commuted through the last shuffle and run at base
        resolution before it, with a ReLU if ``tail_relu``;
        ``compose_tail`` folds it into the last stage's conv, composed in
        f32 and cast to x's dtype once (a ring at the border then differs
        from the sequential form). ``return_preshuffle`` returns the last
        stage before its shuffle (factor ``last_shuffle_factor(scale)``).
        ``pre_kernel`` / ``pre_bias``: a conv before the upsampler, folded
        into the first stage's conv in f32.
        """
        if scale not in STAGES:
            raise ValueError(f"Requested scale={scale} was not built.")
        cf = torch.float32
        stages = STAGES[scale]
        for i, (_, shuffle) in enumerate(stages):
            k = getattr(self, f"s{scale}_c{i}_kernel")
            b = getattr(self, f"s{scale}_c{i}_bias")
            last = i == len(stages) - 1
            if pre_kernel is not None and i == 0:
                k, b = compose_conv3x3_kernels(
                    pre_kernel.to(cf),
                    None if pre_bias is None else pre_bias.to(cf),
                    k.to(cf), b.to(cf))
            pad = (k.shape[0] - 1) // 2
            if tail_kernel is not None and last:
                tk = commute_conv_through_shuffle(tail_kernel.to(cf), shuffle)
                tb = (None if tail_bias is None
                      else tail_bias.repeat_interleave(shuffle * shuffle))
                if compose_tail:
                    kc, bc = compose_conv3x3_kernels(
                        k.to(cf), b.to(cf), tk,
                        None if tb is None else tb.to(cf))
                    x = conv2d(x, kc.to(x.dtype),
                               None if bc is None else bc.to(x.dtype),
                               padding=(kc.shape[0] - 1) // 2,
                               relu=tail_relu)
                else:
                    x = conv2d(x, k, b, padding=pad)
                    x = conv2d(x, tk.to(x.dtype),
                               None if tb is None else tb.to(x.dtype),
                               padding=1, relu=tail_relu)
            else:
                x = conv2d(x, k, b, padding=pad)
            if return_preshuffle and last:
                return x
            x = pixel_shuffle(x, shuffle)
        return x


def last_shuffle_factor(scale: int) -> int:
    """Shuffle factor of the last Upsampler stage for this scale."""
    return STAGES[scale][-1][1]


@functools.lru_cache(maxsize=None)
def _shuffle4_perm(o: int, device) -> torch.Tensor:
    """Output-channel permutation of the two-stage x4 composition: from the
    nested phase order (o, a2, b2, a1, b1) to ``pixel_shuffle(4)`` order
    (o, i, j) with i = 2*a1 + a2 and j = 2*b1 + b2. Copied to ``device``
    once: a CUDA graph cannot capture a copy from pageable host memory."""
    perm = []
    for oc in range(o):
        for i in range(4):
            for j in range(4):
                a1, a2 = i // 2, i % 2
                b1, b2 = j // 2, j % 2
                perm.append((((oc * 2 + a2) * 2 + b2) * 2 + a1) * 2 + b1)
    return torch.tensor(perm, device=device)


def split_tail_kernels(up_params: dict, scale: int, tail_kernel, tail_bias,
                       dtype, pre_kernel=None, pre_bias=None):
    """Branch-B tail as two convs instead of one fold: folding the RGB tail
    into the 64-channel kernel inflates the work through the rank-3 RGB
    bottleneck. Returns ((k_mid, b_mid), (k_fin, b_fin)):

      k_mid: [pre o first stage] without the RGB tail, 5x5 with ``pre``,
             64 -> 3 r_mid^2 at base resolution (r_mid 2 at x2 and x4,
             3 at x3), cast to ``dtype`` with its bias.
      k_fin: the RGB tail (at x4: stage 2 and the tail) commuted through
             every shuffle to base resolution, a 3x3 conv
             3 r_mid^2 -> 3 scale^2 applied after k_mid. It stays f32 with
             its bias: the fold rounds one composed kernel, and
             ``tail_finish_stream`` chooses how the finish weights round.

    Same interior math as ``composed_tail_kernel``; the border ring follows
    the sequential two-conv zero pad. All composition runs in f32.
    """
    stages = STAGES[scale]
    cf = torch.float32
    tb = None if tail_bias is None else tail_bias.to(cf)
    tk = tail_kernel.to(cf)
    k_mid = up_params[f"s{scale}_c0_kernel"].to(cf)
    b_mid = up_params[f"s{scale}_c0_bias"].to(cf)
    if len(stages) == 1:
        r = stages[0][1]
        k_fin = commute_conv_through_shuffle(tk, r)
        b_fin = None if tb is None else tb.repeat_interleave(r * r)
    else:
        if scale != 4 or len(stages) != 2:
            raise ValueError(f"no two-stage split for scale {scale}")
        t2 = commute_conv_through_shuffle(tk, 2)
        tb2 = None if tb is None else tb.repeat_interleave(4)
        u, ub = compose_conv3x3_kernels(up_params["s4_c1_kernel"].to(cf),
                                        up_params["s4_c1_bias"].to(cf), t2, tb2)
        perm = _shuffle4_perm(tk.shape[3], u.device)
        k_fin = commute_conv_through_shuffle(u, 2)[..., perm]
        b_fin = None if ub is None else ub.repeat_interleave(4)[perm]
    if pre_kernel is not None:
        k_mid, b_mid = compose_conv3x3_kernels(
            pre_kernel.to(cf), None if pre_bias is None else pre_bias.to(cf),
            k_mid, b_mid)
    return ((k_mid.to(dtype), None if b_mid is None else b_mid.to(dtype)),
            (k_fin, b_fin))


def composed_tail_kernel(up_params: dict, scale: int, tail_kernel, tail_bias,
                         dtype, pre_kernel=None, pre_bias=None):
    """Fold an Upsampler chain, the trailing 3x3 tail conv commuted through
    its shuffle, and optionally a preceding conv, into ONE base-resolution
    conv emitting ``pixel_shuffle(scale)``-ordered channels.

    Scale 4 also commutes its second stage and the tail through the first
    shuffle, so all the work lands at base resolution; the nested output
    phase order (o, a2, b2, a1, b1) is permuted to shuffle-4 order
    (o, 2*a1+a2, 2*b1+b2). All composition runs in f32 and the result is cast
    to ``dtype`` once. The composed conv zero-pads its input, not the
    intermediates, so a border ring deviates from the sequential form.
    Returns (kernel, bias).
    """
    stages = STAGES[scale]
    cf = torch.float32
    tb = None if tail_bias is None else tail_bias.to(cf)
    tk = tail_kernel.to(cf)
    if len(stages) == 1:
        r = stages[0][1]
        tko = commute_conv_through_shuffle(tk, r)
        tbo = None if tb is None else tb.repeat_interleave(r * r)
        kc, bc = compose_conv3x3_kernels(
            up_params[f"s{scale}_c0_kernel"].to(cf),
            up_params[f"s{scale}_c0_bias"].to(cf), tko, tbo)
    else:
        if scale != 4 or len(stages) != 2:
            raise ValueError(f"no two-stage composition for scale {scale}")
        t2 = commute_conv_through_shuffle(tk, 2)
        tb2 = None if tb is None else tb.repeat_interleave(4)
        u, ub = compose_conv3x3_kernels(up_params["s4_c1_kernel"].to(cf),
                                        up_params["s4_c1_bias"].to(cf), t2, tb2)
        u2 = commute_conv_through_shuffle(u, 2)
        ub2 = None if ub is None else ub.repeat_interleave(4)
        kc, bc = compose_conv3x3_kernels(up_params["s4_c0_kernel"].to(cf),
                                         up_params["s4_c0_bias"].to(cf), u2, ub2)
        perm = _shuffle4_perm(tk.shape[3], kc.device)
        kc = kc[..., perm]
        bc = None if bc is None else bc[perm]
    if pre_kernel is not None:
        kc, bc = compose_conv3x3_kernels(
            pre_kernel.to(cf), None if pre_bias is None else pre_bias.to(cf),
            kc, bc)
    return kc.to(dtype), None if bc is None else bc.to(dtype)
