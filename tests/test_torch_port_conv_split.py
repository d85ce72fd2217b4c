"""The numerics of K1's tensor-core design, on the CPU: 3xTF32.

The CUDA kernel (``vts_torch/csrc/conv3x3.cu``) runs the fp32 conv and its
input gradient on the TF32 tensor cores.  Each operand a is split into
hi = tf32(a), rounded to nearest with ties away from zero (``cvt.rna``), and
lo = a - hi (exact in fp32); the tensor core reads only the top 19 bits of
each word, so lo is cut to tf32 on its way in.  Per 8-channel chunk the
kernel sums the nine taps' lo(w)·hi(x), then hi(w)·lo(x), then hi·hi, in
the tensor cores, and adds each chunk into the running fp32 sum in
registers.  The tensor cores round their sums toward zero: the emulation
adds each 8-channel product (exact) to the fp32 partial sum and truncates
the result toward zero, a model of that rounding, not of the cores' exact
alignment.  This file emulates those products and sums with numpy and holds
them to the limit the card is held to (1e-4·max|ref| + 1e-5) against the
JAX package's Pallas conv (interpret mode) and lax.conv, forward and VJP:
the design keeps fp32 accuracy.  One TF32 pass misses that limit, which is
why there are three; one accumulator carried over all of K biases the
outputs toward zero, which is why each chunk has its own.

bf16 (the ``--dtype bfloat16`` lane) runs the kernel's bf16 instance: one
bf16 pass, each 16-channel step of each tap one tensor-core sum of 16 exact
products (added with round toward zero), a fresh fragment per 64 channels,
the chunks added in fp32 with round to nearest, then bias and ReLU in fp32
and one round to nearest bf16.  The last tests emulate that and hold it to
the Pallas conv in bf16 within one bf16 rounding, and show why the chunk is
64 channels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vts_tpu.ops.pallas_conv import conv3x3_relu
from tests.torch_port_step import one_intra_op_thread  # noqa: F401  (autouse fixture)

MASK = np.uint32(0xFFFFE000)          # the 13 low mantissa bits a tensor core drops


def _tf32_rna(a):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    return ((a.view(np.uint32) + np.uint32(0x1000)) & MASK).view(np.float32)


def _tc_read(a):
    """The tensor core's read of an fp32 word: its top 19 bits."""
    return (a.view(np.uint32) & MASK).view(np.float32)


def _add_rz(acc, prod):
    """acc + prod (float32 + float64) rounded toward zero to float32, as the
    tensor cores round a sum."""
    exact = acc.astype(np.float64) + prod
    out = exact.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def _conv_3xtf32(x, w, passes=3, per_chunk=True):
    """x (N, H, W, C), w (3, 3, C, Co), float32 → the kernel's conv (no bias),
    float32: per 8-channel chunk the taps' lo(w)·hi(x), hi(w)·lo(x), hi·hi
    summed in the tensor cores (each product added with round toward zero),
    chunks added in fp32 with round to nearest.  ``per_chunk=False``: one
    tensor-core accumulator over all of K.  ``passes=1``: the plain TF32
    product of the operands as read (hi·hi of the truncated words)."""
    n, h, wd, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    if passes == 1:
        terms = [(_tc_read(xp), _tc_read(w))]
    else:
        xhi, whi = _tf32_rna(xp), _tf32_rna(w)
        xlo, wlo = _tc_read(xp - xhi), _tc_read(w - whi)
        terms = [(xhi, wlo), (xlo, whi), (xhi, whi)]
    terms = [(a.astype(np.float64), b.astype(np.float64)) for a, b in terms]
    acc = part = np.zeros((n, h, wd, w.shape[-1]), np.float32)
    for c0 in range(0, c, 8):
        if per_chunk:
            part = np.zeros_like(acc)
        for a, b in terms:
            for dy in range(3):
                for dx in range(3):
                    part = _add_rz(part, a[:, dy:dy + h, dx:dx + wd, c0:c0 + 8]
                                   @ b[dy, dx, c0:c0 + 8])
        if per_chunk:
            acc = acc + part
    return acc if per_chunk else part


def _lax_conv(x, w, b):
    y = jax.lax.conv_general_dilated(x, w, (1, 1), [(1, 1), (1, 1)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return jnp.maximum(y + b, 0.0)


def _inputs(cin, cout, spread):
    """ReLU'd activations and He-scaled weights, as the LPIPS convs see them;
    ``spread`` scales the activations by 1e-3…1e3."""
    rng = np.random.default_rng(cin * 3 + cout + spread)
    x = np.maximum(rng.normal(size=(1, 8, 16, cin)), 0.0)
    if spread:
        x = x * 10.0 ** rng.uniform(-3, 3, size=x.shape)
    w = rng.normal(size=(3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin))
    b = rng.normal(size=(cout,)) * 0.1
    gy = rng.normal(size=(1, 8, 16, cout))
    return [a.astype(np.float32) for a in (x, w, b, gy)]


def _err(got, ref):
    """max |Δ| as a fraction of the limit 1e-4·max|ref| + 1e-5."""
    return np.abs(got - ref).max() / (1e-4 * np.abs(ref).max() + 1e-5)


@pytest.mark.parametrize("cin,cout,spread", [(64, 64, False), (64, 128, False),
                                             (128, 128, False), (64, 128, True)])
def test_3xtf32_conv_meets_the_fp32_limit(cin, cout, spread):
    x, w, b, gy = _inputs(cin, cout, spread)
    xj, wj, bj, gyj = (jnp.asarray(a) for a in (x, w, b, gy))
    pallas = lambda x_: conv3x3_relu(x_, wj, bj, relu=True, th=8, interpret=True)
    y_pallas, vjp_pallas = jax.vjp(pallas, xj)
    y_lax, vjp_lax = jax.vjp(lambda x_: _lax_conv(x_, wj, bj), xj)
    y_pallas, y_lax = np.asarray(y_pallas), np.asarray(y_lax)
    (dx_pallas,), (dx_lax,) = vjp_pallas(gyj), vjp_lax(gyj)

    y = np.maximum(_conv_3xtf32(x, w) + b, 0.0)
    # dx: gy·[y > 0] (the saved output) convolved with w flipped, in/out swapped
    g = np.where(y_pallas > 0, gy, 0.0).astype(np.float32)
    wt = np.ascontiguousarray(np.flip(w, (0, 1)).transpose(0, 1, 3, 2))
    dx = _conv_3xtf32(g, wt)
    for got, ref in ((y, y_pallas), (y, y_lax), (dx, np.asarray(dx_pallas)),
                     (dx, np.asarray(dx_lax))):
        assert _err(got, ref) <= 1.0, _err(got, ref)


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 128)])
def test_one_tf32_pass_misses_the_fp32_limit(cin, cout):
    """Why three passes: the tensor core's single TF32 product of the fp32
    words misses the same limit that three passes meet by a wide margin."""
    x, w, b, _ = _inputs(cin, cout, False)
    ref = np.asarray(_lax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    three = np.maximum(_conv_3xtf32(x, w) + b, 0.0)
    one = np.maximum(_conv_3xtf32(x, w, passes=1) + b, 0.0)
    assert _err(three, ref) <= 0.05
    assert _err(one, ref) > 1.0


def _conv_f64(x, w):
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    h, wd = x.shape[1:3]
    return sum(xp[:, dy:dy + h, dx:dx + wd] @ w[dy, dx].astype(np.float64)
               for dy in range(3) for dx in range(3))


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 128)])
def test_per_chunk_sums_keep_the_bias_off(cin, cout):
    """Why each 8-channel chunk sums into a fresh fragment: carried over all
    of K in the tensor cores, the sum is truncated toward zero 27 times a
    chunk at its full size and shrinks by a few 1e-6 relative, a bias that
    adds up in a weight gradient summed over pixels.  Per chunk it stays
    under the 1e-6 that chip_smoke.py holds the kernel to against fp64."""
    x, w, _, _ = _inputs(cin, cout, False)
    ref = _conv_f64(x, w)

    def bias(got):
        return ((got - ref) * np.sign(ref)).mean() / np.abs(ref).mean()

    chunked, single = bias(_conv_3xtf32(x, w)), bias(_conv_3xtf32(x, w, per_chunk=False))
    assert abs(chunked) < 1e-6, chunked
    assert single < -1e-6, single


def _bf16(a):
    """Round float32 to the nearest bfloat16 (ties to even), kept as float32."""
    u = np.asarray(a, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _conv_bf16(x, w, chunk=64):
    """x (N, H, W, C), w (3, 3, C, Co), bf16 values in float32 → the bf16
    instance's fp32 sums (no bias): per ``chunk`` channels a fresh
    accumulator; per 16-channel step and tap the 16 exact products summed
    and added to it with round toward zero; the chunks added in fp32 with
    round to nearest."""
    n, h, wd, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0))).astype(np.float64)
    w64 = w.astype(np.float64)
    acc = np.zeros((n, h, wd, w.shape[-1]), np.float32)
    for c0 in range(0, c, chunk):
        part = np.zeros_like(acc)
        for k0 in range(c0, min(c0 + chunk, c), 16):
            for dy in range(3):
                for dx in range(3):
                    part = _add_rz(part, xp[:, dy:dy + h, dx:dx + wd, k0:k0 + 16]
                                   @ w64[dy, dx, k0:k0 + 16])
        acc = acc + part
    return acc


def _bf16_inputs(cin, cout):
    x, w, b, gy = _inputs(cin, cout, False)
    return _bf16(x), _bf16(w), b, _bf16(gy)


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 128)])
def test_bf16_one_pass_meets_the_bf16_limit(cin, cout):
    """The bf16 instance's arithmetic against the Pallas conv in bf16
    (interpret), forward and VJP: both sum exact products in fp32 and round
    once, so they differ by at most one bf16 rounding, 2^-7·|ref| + 1e-5."""
    x, w, b, gy = _bf16_inputs(cin, cout)
    bf = jnp.bfloat16
    xj, wj, gyj = (jnp.asarray(a, bf) for a in (x, w, gy))
    y_pallas, vjp = jax.vjp(lambda a: conv3x3_relu(a, wj, jnp.asarray(b), relu=True, th=8,
                                                   interpret=True), xj)
    (dx_pallas,) = vjp(gyj)
    y_pallas, dx_pallas = (np.asarray(t).astype(np.float32) for t in (y_pallas, dx_pallas))

    y = _bf16(np.maximum(_conv_bf16(x, w) + b, 0.0))
    g = np.where(y_pallas > 0, gy, 0.0).astype(np.float32)
    wt = np.ascontiguousarray(np.flip(w, (0, 1)).transpose(0, 1, 3, 2))
    dx = _bf16(_conv_bf16(g, wt))
    for got, ref in ((y, y_pallas), (dx, dx_pallas)):
        assert np.all(np.abs(got - ref) <= 2 ** -7 * np.abs(ref) + 1e-5)


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 128), (256, 64)])
def test_bf16_chunks_keep_the_bias_off(cin, cout):
    """Why the bf16 instance sums each 64 channels in a fresh fragment: its
    fp32 sums' relative bias against fp64 of the same bf16 operands stays
    near -2.6e-7 whatever C is, while one tensor-core accumulator over all
    of K drifts with C (9·C/16 truncations) and passes the 1e-6 that
    chip_smoke.py holds the kernel to at C = 256.  (A 128-channel chunk
    reads ~-6e-7; 64 keeps a margin for the model of the cores' rounding.)"""
    x, w, _, _ = _bf16_inputs(cin, cout)
    ref = _conv_f64(x, w)

    def bias(got):
        return ((got - ref) * np.sign(ref)).mean() / np.abs(ref).mean()

    chunked, single = bias(_conv_bf16(x, w)), bias(_conv_bf16(x, w, chunk=cin))
    assert abs(chunked) < 1e-6, chunked
    assert single <= chunked, (single, chunked)
    if cin > 128:
        assert single < -1e-6, single
