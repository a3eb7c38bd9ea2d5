"""The fused trunk's rowwise int8 mode (JAX ``fused_window_trunk_v2(...,
int8_acts="rowwise")``, FastTransformer ``int8_trunk=True``) on the CPU,
where the wrapper computes its plain version, against the JAX package:

- the port's quantization (transformerupscaler_torch/ops/quant.py) bit for
  bit against the rowwise weights ``fused_window_trunk_v2`` makes with
  ``trunk2.quantize_gemm_weights`` and the kernel body's per-token
  activation quantize;
- the plain int8 trunk against the JAX kernel in Pallas interpret mode at
  C=192, 12 heads (two windows, two layers; each JAX call once per module);
- FastTransformer's int8 trunk route: the flag's reach at a small width,
  and at full width in bf16 against the committed JAX output
  ``tests/fixtures/torch_port/bench_int8_trunk_x2_bf16.npz`` (the bench.py
  route with ``int8_trunk=True``, 8x16 -> 12x24: one window, the smallest
  input the serving gate takes), which ``chip_smoke.py`` holds the card to.
  Regenerate it with ``PYTHONPATH=. python tests/test_torch_int8_trunk.py``
  from the repo root.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_fixtures import DIR, _assert_fresh, jax_fixture
from test_torch_trunk_widths import Trunk
from transformerupscaler_tpu.ops.pallas.trunk2 import (
    fused_window_trunk_v2,
    quantize_gemm_weights as jax_quantize_gemm_weights,
)
from transformerupscaler_torch.kernels import trunk2 as T
from transformerupscaler_torch.models.common import run_window_trunk
from transformerupscaler_torch.ops.quant import quantize_rows, rowwise_weights
from transformerupscaler_torch.registry import get_model
from transformerupscaler_torch.weights import params_from_jax, seeded_params

DIM, HEADS, WS, LAYERS, N_WIN = 192, 12, 8, 2, 2
ROUTE = dict(compose_tails=True, pallas_serve=True, attn_impl="fused2",
             int8_trunk=True)
BENCH_INT8 = (os.path.join(DIR, "bench_int8_trunk_x2_bf16.npz"),
              "FastTransformer", dict(attn_impl="fused2", int8_trunk=True),
              (8, 16), (12, 24))
SMALL = dict(transformer_dim=32, num_window_blocks=2, num_heads=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_gemm_weights_matches_jax(rng, dtype):
    """Bit for bit, the rowwise mode's weights as fused_window_trunk_v2
    makes them (trunk2.py:724-734): ``quantize_gemm_weights`` with unit
    input scales, then sw * 127, which differs from the unscaled maximum /
    127 in some channels."""
    w = (rng.standard_normal((2, 192, 576)) / np.sqrt(192)).astype(np.float32)
    wj = jnp.asarray(w).astype(dtype)
    wq, sw, _ = jax_quantize_gemm_weights(wj, jnp.ones((2, 192), jnp.float32))
    q, s = rowwise_weights(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (2, 192, 576) and s.shape == (2, 576)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sw * 127.0)[:, 0])


def test_quantize_rows_matches_jax(rng):
    """The kernel body's per-token quantize (trunk2.py:176-178), bit for bit,
    on rows of mixed magnitudes and an all-zero row."""
    x = (rng.standard_normal((64, 192))
         * rng.uniform(0.01, 10.0, (64, 1))).astype(np.float32)
    x[5] = 0.0
    xf = jnp.asarray(x)
    srow = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True),
                       1e-6) * (1.0 / 127.0)
    xq = jnp.round(xf * (1.0 / srow))
    got_q, got_s = quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(srow))
    assert np.abs(got_q.numpy()).max() == 127.0


def _case():
    trunk = Trunk(DIM)
    tree = seeded_params(trunk, 21)
    params_from_jax(trunk, tree)
    win = np.random.default_rng(21).standard_normal(
        (N_WIN, WS * WS, DIM)).astype(np.float32)
    return trunk, tree, win


@pytest.fixture(scope="module")
def jax_int8():
    """dtype -> the JAX rowwise int8 kernel's output, f32 numpy."""
    _, tree, win = _case()
    blocks = [tree[f"blocks_{i}"] for i in range(LAYERS)]
    return {dt: np.asarray(fused_window_trunk_v2(
        jnp.asarray(win).astype(dt), blocks, HEADS, WS, int8_acts="rowwise",
        interpret=True), np.float32) for dt in ("float32", "bfloat16")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_plain_matches_pallas(jax_int8, dtype):
    """Both sides quantize the same values the same way (the tests above),
    but a GEMM input that differs by a float rounding can land on the other
    side of an int8 rounding boundary: that row's product then moves by one
    quantization step, srow * |w| (about 1/127 of the row's largest input
    times a weight), and attention carries it into the window's other
    tokens. f32, measured: one flipped row of 128 after one layer; after two
    max abs 0.036, mean 2.4e-3 at values of about 1; bounds max <= 0.1, mean
    <= 6e-3. bf16, where the bf16 flips of the other modes add their own:
    measured max 0.082, mean 0.0138; bounds max <= 0.25, mean <= 0.03, and
    the port's mean distance to the JAX f32 int8 result at most 1.25 times
    the JAX bf16 kernel's."""
    trunk, _, win = _case()
    tdt = getattr(torch, dtype)
    params = T.stack_trunk_params(trunk.blocks, tdt, int8_rowwise=True)
    assert params["wpack_i8"].shape == (LAYERS, 48, DIM, 64)
    assert params["swpack"].shape == (LAYERS, 9 * DIM)
    with torch.inference_mode():
        got = T.fused_window_trunk(torch.from_numpy(win).to(tdt), params,
                                   "int8_rowwise")
    assert got.dtype == tdt and got.shape == win.shape
    got, want = got.float().numpy(), jax_int8[dtype]
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= 0.1 and err.mean() <= 6e-3, (err.max(),
                                                         err.mean())
        return
    assert err.max() <= 0.25 and err.mean() <= 0.03, (err.max(), err.mean())
    exact = jax_int8["float32"]
    ours, theirs = np.abs(got - exact).mean(), np.abs(want - exact).mean()
    assert ours <= 1.25 * theirs, (ours, theirs)


def _unpack_slabs(pack, c, fc1_twice):
    """The int8 kernel's slabs (L, n, C, 64) read back in the order the
    kernel consumes them, independently of ``trunk2._pack_slabs``: per
    head group the k, v, q output chunks (C/64 tiles of [64 outputs][64
    inputs]) and proj's rows ([C outputs][64 K slots]); per hidden chunk
    fc1's chunk and fc2's rows ("int8_rowwise": every group's chunks, then
    proj's rows, then fc1's chunks once alone before the pairs). Returns
    {gemm: (L, in, out) int64} with each rows slab's K slots undone: slot
    4t + e of each 16 holds input 2t + e % 2 + 8 (e // 2), the order in
    which the kernel fills an int8 A fragment."""
    slot = [2 * (s // 4) + s % 2 + 8 * (s % 4 // 2) for s in range(16)]
    order = torch.tensor([16 * (s // 16) + slot[s % 16] for s in range(64)])
    slabs = iter(pack.long().unbind(1))
    layers = pack.shape[0]
    out = {k: torch.zeros(layers, c if k != "fc2w" else 4 * c,
                          {"qkvw": 3 * c, "fc1w": 4 * c}.get(k, c),
                          dtype=torch.long) for k in T.GEMMS}

    def chunk(name, o0):  # [kt][64 outputs][64 inputs] -> (L, C, 64)
        t = next(slabs).reshape(layers, c // 64, 64, 64).transpose(2, 3)
        out[name][:, :, o0:o0 + 64] = t.reshape(layers, c, 64)

    def rows(name, i0):  # [C outputs][64 slots] -> inputs i0 + order
        out[name][:, i0 + order, :] = next(slabs).transpose(1, 2)

    groups = range(0, c, 64)
    for i0 in groups:
        chunk("qkvw", c + i0)
        chunk("qkvw", 2 * c + i0)
        chunk("qkvw", i0)
        if not fc1_twice:
            rows("projw", i0)
    if fc1_twice:
        for i0 in groups:
            rows("projw", i0)
        for i0 in range(0, 4 * c, 64):
            chunk("fc1w", i0)
    for i0 in range(0, 4 * c, 64):
        chunk("fc1w", i0)
        rows("fc2w", i0)
    assert next(slabs, None) is None
    return out, order


@pytest.mark.parametrize("mode", ["int8_rowwise", "int8_static"])
def test_int8_slab_packs(rng, mode):
    """Both int8 modes' weight packs, unpacked in the kernel's slab order
    with the K order undone, equal the quantized weights ``<gemm>_q``
    (rowwise; fc1 twice) or ``<gemm>_sq`` (static) block for block; and
    fc2's product taken over the permuted K slots, as the kernel's
    fragments feed it, equals xq @ wq exactly in int64."""
    trunk, _, _ = _case()
    p = T.stack_trunk_params(trunk.blocks[:LAYERS], torch.bfloat16,
                             int8_rowwise=True)
    if mode == "int8_static":
        s = [torch.from_numpy(rng.uniform(0.5, 4.0, (LAYERS, n))
                              .astype(np.float32))
             for n in (DIM, DIM, DIM, 4 * DIM)]
        p = T.add_static_int8(p, s)
    key, suffix = T.PACKS[mode][0], "_q" if mode == "int8_rowwise" else "_sq"
    slabs = (16 if mode == "int8_rowwise" else 12) * DIM // 64
    assert p[key].shape == (LAYERS, slabs, DIM, 64)
    assert p[key].dtype == torch.int8
    got, order = _unpack_slabs(p[key], DIM, mode == "int8_rowwise")
    assert sorted(order.tolist()) == list(range(64))
    assert list(order[:16]) == list(T.K_PERM)
    for k in T.GEMMS:
        assert torch.equal(got[k], p[k + suffix].long()), k
    # fc2's slabs straight from the pack: the K slots of the 12 hidden
    # chunks side by side, (C outputs, 4C slots).
    first = slabs - 24 + 1
    b = p[key][1, first::2].long().permute(1, 0, 2).reshape(DIM, 4 * DIM)
    xq = torch.from_numpy(rng.integers(-127, 128, (64, 4 * DIM)))
    perm = torch.cat([i0 + order for i0 in range(0, 4 * DIM, 64)])
    assert torch.equal(xq[:, perm] @ b.t(), xq @ p["fc2w" + suffix][1].long())


def test_int8_product_is_exact(rng):
    """The plain int8 product sums int8 x int8 exactly (float64), whatever
    the order: it equals the int64 product of the quantized operands."""
    trunk, _, win = _case()
    p = T.stack_trunk_params(trunk.blocks, torch.float32, int8_rowwise=True)
    x = torch.from_numpy(win[0])
    xq, srow = quantize_rows(x)
    want = (xq.numpy().astype(np.int64) @ p["fc1w_q"][1].numpy()
            .astype(np.int64)).astype(np.float32)
    got = T._product(x, p, "fc1w", 1, "int8_rowwise")
    np.testing.assert_array_equal(
        got.numpy(), (torch.from_numpy(want) * srow * p["fc1w_sw"][1]).numpy())


def test_int8_acts_routing(rng):
    """``int8_acts="rowwise"`` reaches the int8 mode on "fused2" only, as in
    JAX: "xla" and "fused" ignore it (bit-identical to without); a static
    per-channel tuple of the wrong shapes (fc2's input is 4C wide) and an
    unknown string are refused there (the static mode itself:
    tests/test_torch_int8_static_trunk.py)."""
    trunk, _, _ = _case()
    tokens = torch.from_numpy(
        rng.standard_normal((1, 8, 16, DIM)).astype(np.float32))
    for impl in ("xla", "fused"):
        torch.testing.assert_close(
            run_window_trunk(tokens, trunk.blocks, WS, impl,
                             int8_acts="rowwise"),
            run_window_trunk(tokens, trunk.blocks, WS, impl), atol=0, rtol=0)
    i8 = run_window_trunk(tokens, trunk.blocks, WS, "fused2",
                          int8_acts="rowwise")
    bf = run_window_trunk(tokens, trunk.blocks, WS, "fused2")
    assert not torch.equal(i8, bf)
    torch.testing.assert_close(i8, bf, atol=0.25, rtol=0)
    with pytest.raises(ValueError, match="int8_acts"):
        run_window_trunk(tokens, trunk.blocks, WS, "fused2",
                         int8_acts=(np.ones((2, DIM)),) * 4)
    with pytest.raises(ValueError, match="int8_acts"):
        run_window_trunk(tokens, trunk.blocks, WS, "fused2",
                         int8_acts="columnwise")


@pytest.mark.parametrize("impl", ["fused2", "fused", "xla"])
def test_int8_trunk_flag_reaches_the_trunk(impl):
    """FastTransformer (dim 32, 2 heads of 16, 2 blocks) with
    ``int8_trunk=True``, 16x32 -> 24x48 at f32: under "fused2" the stacked
    weights carry the int8 ones and the output moves, by int8 rounding only
    (max abs <= 2e-2 beside the bf16-free output); under "fused" and "xla"
    the flag is ignored, as in JAX: bit-identical to ``int8_trunk=False``.
    The route against the JAX model at full width: the fixture tests
    below."""
    x = torch.from_numpy(np.random.default_rng(1).random((1, 16, 32, 3))
                         .astype(np.float32))
    outs = {}
    for flag in (True, False):
        model = get_model("FastTransformer", device="cpu",
                          **{**ROUTE, "attn_impl": impl, "int8_trunk": flag},
                          **SMALL)
        params_from_jax(model, seeded_params(model, 3))
        outs[flag] = model(x, res_out=(24, 48))
        if impl != "xla":
            assert ("fc1w_q" in model.trunk_params()) == (flag and
                                                          impl == "fused2")
    if impl == "fused2":
        assert not torch.equal(outs[True], outs[False])
        torch.testing.assert_close(outs[True], outs[False], atol=2e-2, rtol=0)
    else:
        torch.testing.assert_close(outs[True], outs[False], atol=0, rtol=0)


@pytest.fixture(scope="module")
def bench_int8_jax():
    path, name, route, in_hw, res_out = BENCH_INT8
    return jax_fixture(route, in_hw, res_out, name)


def test_bench_int8_trunk_fixture_is_fresh(bench_int8_jax):
    """The committed JAX output equals what the JAX model gives now."""
    assert os.path.getsize(BENCH_INT8[0]) < 100_000
    _assert_fresh(BENCH_INT8[0], bench_int8_jax)


def test_bench_int8_trunk_route_matches_jax(bench_int8_jax):
    """The full-width FastTransformer (dim 192, 6 blocks, 12 heads) on the
    bench.py route with the int8 trunk, bf16, against the JAX model: the
    interior (4 pixels cropped) within max abs 3e-2 and mean abs 3e-3, the
    limits of the other routes' fixtures."""
    path, name, route, _, res_out = BENCH_INT8
    model = get_model(name, device="cpu", dtype=torch.bfloat16,
                      compose_tails=True, pallas_serve=True, **route)
    params_from_jax(model, seeded_params(model, int(bench_int8_jax["seed"])))
    got = model(torch.from_numpy(bench_int8_jax["x"]),
                res_out=res_out).float().numpy()
    assert got.shape == bench_int8_jax["y"].shape == (1, *res_out, 3)
    err = np.abs(got - bench_int8_jax["y"])[:, 4:-4, 4:-4]
    assert err.max() <= 3e-2 and err.mean() <= 3e-3, (err.max(), err.mean())


if __name__ == "__main__":
    path, name, route, in_hw, res_out = BENCH_INT8
    np.savez_compressed(path, **jax_fixture(route, in_hw, res_out, name))
    print("wrote", path, os.path.getsize(path), "bytes")
