"""The bf16 wgmma Griffin-Lim kernel's data layout (``csrc/gl_audio.cu``
``gl_wgmma_kernel``, ``csrc/wgmma.cuh``, ``ops/wgmma_layout.py``), emulated
in numpy on the CPU.

The kernel keeps one bf16 image of the forward [cos | sin] operand in shared
memory and reads it through matrix descriptors: K-major for the forward
product, MN-major (transposed) for the inverse.  Emulated here: the
hardware's 128-byte swizzle of a shared-memory address and the descriptors'
start offsets, strides and k-steps, which must give the operand and its
transpose; the warpgroup's register maps, thread by thread (the forward
accumulator's (row, column) per register, the cos and sin columns of a bin
in one thread for the phase step, the accumulator as the next product's
register A operand, the overlap-add of samples n and n -+ 160 in one
thread); and one tile of 32 blocks through all of them, one and two
Griffin-Lim iterations, against the plain bf16 version ``_gl_loop_plain``.
"""

import numpy as np
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import filter_design as t_fd
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as t_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir as t_iir
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import tf32, wgmma_layout

KBLOCK = 64 * 256 * 2   # bytes of one 64-sample K block of the image (the MN-major LBO)
SBO = 1024              # bytes from one 8-row atom to the next


@pytest.fixture(scope="module")
def ops():
    return cuda_gl.make_gl_audio_ops(t_gl.make_streaming_gl_ops(40, 16000.0, torch.float32),
                                     t_iir.sos_to_statespace(t_fd.gl_output_lowpass_sos()),
                                     torch.float32)


def _swizzle(addr):
    """The 128-byte swizzle applied to a shared-memory byte address: its
    16-byte chunk (bits 4-6) XOR its row in the 1,024-byte atom (bits 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _values(image):
    """The image's bf16 values as float64, indexed by byte address / 2."""
    return image.float().double().numpy()


def _read_k_major(image, K=256, N=256):
    """B (K, N) as the forward product's descriptors read it: k-step s starts
    at K block s // 4, 32 bytes per k-step into the 128-byte rows; row n of
    an atom at 128 n, atoms SBO apart; value kk of the k-step at 2 kk."""
    v = _values(image)
    n, kk = np.arange(N)[:, None], np.arange(16)[None, :]
    out = np.empty((K, N))
    for s in range(K // 16):
        start = (s // 4) * (N * 128) + (s % 4) * 32
        out[16 * s : 16 * s + 16] = v[_swizzle(start + (n // 8) * SBO + (n % 8) * 128 + 2 * kk) // 2].T
    return out


def _read_mn_major(image, K=256, N=256):
    """B (K, N) as the inverse's descriptors read the same image: k-step s
    starts at row 16 s (2,048 s bytes); row kk at 128 kk within its 8-row
    group, groups SBO apart; value n at 2 (n % 64) within a row, 64-value
    blocks KBLOCK apart (LBO)."""
    v = _values(image)
    kk, n = np.arange(16)[:, None], np.arange(N)[None, :]
    out = np.empty((K, N))
    for s in range(K // 16):
        addr = 2048 * s + (kk // 8) * SBO + (kk % 8) * 128 + (n // 64) * KBLOCK + 2 * (n % 64)
        out[16 * s : 16 * s + 16] = v[_swizzle(addr) // 2]
    return out


def _maps():
    """(row, column) of each of the 128 threads' 128 accumulator registers
    of an m64n256 product, d[4j + 2h + e] = D[16w + g + 8h][8j + 2q + e], and
    of its 16 k-steps x 4 registers x 2 halves of a register A operand,
    a[s][r] = A[16w + g + 8(r & 1)][16 s + 8(r >> 1) + 2q + (0, 1)], in the
    order 8 s + 2 r + half."""
    tw = np.arange(128)[:, None]
    w, g, q = tw // 32, (tw % 32) // 4, tw % 4
    p = np.arange(128)[None, :]
    j, h, e = p // 4, (p // 2) % 2, p % 2
    d_rows, d_cols = 16 * w + g + 8 * h, 8 * j + 2 * q + e
    s, r, half = p // 8, (p // 2) % 4, p % 2
    a_rows, a_cols = 16 * w + g + 8 * (r & 1), 16 * s + 8 * (r >> 1) + 2 * q + half
    return (d_rows, d_cols), (a_rows, a_cols)


def _gather(m, rc):
    return m[rc[0], rc[1]]


def _scatter(v, rc, shape=(64, 256)):
    out = np.full(shape, np.nan)
    out[rc[0], rc[1]] = v
    return out


def _bf16(x):
    return tf32.bf16_round(torch.as_tensor(np.asarray(x, np.float32))).numpy().astype(np.float64)


@pytest.mark.parametrize("K,N", [(256, 256), (64, 8), (128, 64)])
def test_image_unpacks_to_the_operand(rng, K, N):
    m = torch.as_tensor(rng.randn(K, N), dtype=torch.float32)
    image = wgmma_layout.sw128_image(m)
    assert image.dtype == torch.bfloat16 and image.shape == (K * N,)
    assert torch.equal(wgmma_layout.unpack_image(image, K, N), m.to(torch.bfloat16))
    with pytest.raises(ValueError, match="K % 64"):
        wgmma_layout.sw128_image(m[:, :4] if N > 8 else m[:32])


def test_descriptors_read_the_operand_and_its_transpose(ops):
    """The forward descriptors read GLAudioOps.gl_bf16's image as the bf16
    forward operand; the inverse's read it as that operand transposed."""
    image, fwd = ops.gl_bf16[2], ops.gl_bf16[0].double().numpy()
    assert np.array_equal(_read_k_major(image), fwd)
    assert np.array_equal(_read_mn_major(image), fwd.T)


def test_register_maps(rng):
    """The accumulator of a product is the register A operand of the next
    (position 8 s + 2 r + half of one thread is the same (row, column));
    every (row, column) of the 64 x 256 tile in exactly one thread; a bin's
    cos and sin columns (k, 128 + k) in one thread at positions p, p + 64;
    a block's two frames (rows g, g + 8) and samples n, n + 160 (columns
    j, j + 20) in one thread; a plain (64, 256) @ (256, 256) product
    gathered by the map is each thread's registers."""
    (dr, dc), (ar, ac) = _maps()
    assert np.array_equal(dr, ar) and np.array_equal(dc, ac)
    assert len(set(zip(dr.ravel(), dc.ravel()))) == 64 * 256
    assert np.array_equal(dr[:, :64], dr[:, 64:]) and np.array_equal(dc[:, 64:], dc[:, :64] + 128)
    assert np.array_equal(dr[:, 2::4] - 8, dr[:, 0::4]) and (dr[:, 0::4] % 16 < 8).all()
    assert np.array_equal(dc[:, 80:], dc[:, :48] + 160) and np.array_equal(dr[:, 80:], dr[:, :48])
    a, b = rng.randn(64, 256), rng.randn(256, 256)
    registers = _gather(a, (ar, ac))
    assert np.array_equal(_scatter(registers, (ar, ac)), a)
    assert np.array_equal(_gather(_scatter(registers, (ar, ac)) @ b, (dr, dc)), _gather(a @ b, (dr, dc)))


def _emulate_tile(lm, rand, ops, iterations, phase_bug):
    """gl_wgmma_kernel on one tile of 32 blocks (rand (32, 480), lm (33, NM)),
    thread by thread: the frames in the accumulator layout, their bf16 A
    operand and fp32 Nyquist bins, the forward product through the image's
    K-major reads, the phase step on the registers (cos at p, sin at p + 64),
    Z times the inverse's weights as the register A operand, the inverse
    through the MN-major reads, the Nyquist row, window and overlap-add."""
    f32 = np.float32
    (rows, cols), _ = _maps()
    image = ops.gl_bf16[2]
    bk, bmn = _read_k_major(image), _read_mn_major(image)
    minv, _, _, fnyq, inyq, win = (t.numpy() for t in ops.gl_f32)
    spec = (np.exp(lm.astype(np.float64)) @ minv.astype(np.float64)).astype(f32)  # (33, 129)
    r64 = np.arange(64)
    row_block = r64 // 16 * 8 + r64 % 8           # a tile row's block; its frame is row % 16 // 8
    row_spec = row_block + (r64 % 16) // 8         # its log-mel row
    block, n = row_block[rows], cols              # per thread and register
    w = win[n]
    f = rand[block, 160 * ((rows % 16) // 8) + n] * w
    weights = np.where(cols[:, :64] == 0, f32(1 / 256), f32(2 / 256))
    for it in range(iterations):
        xn = np.zeros(64)
        np.add.at(xn, rows.ravel(), (f.astype(np.float64) * fnyq[n]).ravel())
        xn = xn.astype(f32)
        x = _gather(_scatter(_bf16(f), (rows, cols)) @ bk, (rows, cols)).astype(f32)
        xr, xi, sp = x[:, :64], -x[:, 64:], spec[row_spec[rows[:, :64]], cols[:, :64]]
        sp_n = spec[row_spec, 128]
        if phase_bug:
            ang = np.where(cols[:, :64] == 0, np.where(xr < 0, f32(np.pi), f32(0)),
                           np.arctan2(xi, xr)).astype(f32)
            zr, zi = sp * np.exp(ang), np.zeros_like(sp)
            zn = sp_n * np.exp(np.where(xn < 0, f32(np.pi), f32(0))).astype(f32)
        else:
            r = np.sqrt(xr * xr + xi * xi)
            inv = np.where(r > 0, 1 / np.where(r > 0, r, 1), 0).astype(f32)
            zr, zi = sp * np.where(r > 0, xr * inv, 1).astype(f32), sp * (xi * inv)
            zn = sp_n * np.where(xn < 0, f32(-1), f32(1))
        z = np.concatenate([_bf16(zr * weights), _bf16(-zi * weights)], axis=1)
        y = _gather(_scatter(z, (rows, cols)) @ bmn, (rows, cols)).astype(f32)
        t = ((y + zn[rows] * inyq[n]) * w).reshape(128, 32, 2, 2)  # (thread, j, frame, e)
        t0, t1, wj = t[:, :, 0], t[:, :, 1], w.reshape(128, 32, 2, 2)[:, :, 0]
        if it + 1 < iterations:  # sample n -+ 160 is column j -+ 20 of the same thread
            late, early = np.zeros_like(t0), np.zeros_like(t0)
            late[:, 20:], early[:, :12] = t1[:, :12], t0[:, 20:]
            f = np.stack([(t0 + late) * wj, (early + t1) * wj], axis=2).reshape(128, 128)
    out = np.zeros((32, 480), f32)
    o = np.zeros((128, 60, 2), f32)
    o[:, :32] += t0
    o[:, 20:52] += t1
    samples = 8 * np.arange(60)[None, :, None] + 2 * (np.arange(128) % 4)[:, None, None] + np.arange(2)
    out[np.broadcast_to(block[:, :1, None], samples.shape), samples] = o
    return out


@pytest.mark.parametrize("iterations,phase_bug", [(1, True), (1, False), (2, False)])
def test_tile_through_the_maps_matches_the_plain_bf16_version(ops, rng, iterations, phase_bug):
    """One tile of 32 blocks emulated thread by thread (float64 products of
    the bf16 values) against ``_gl_loop_plain``: they differ only where
    another summation order moves a value across a bf16 rounding step;
    max |diff| within 1e-3 of the blocks' max |value| (the kernel's gate)."""
    w = np.cumsum(rng.randn(33, 40) * 0.15, axis=0)
    lm = (w - w.mean() - 1.0).astype(np.float32)
    rand = rng.rand(32, 480).astype(np.float32)
    got = _emulate_tile(lm, rand, ops, iterations, phase_bug)
    ref = cuda_gl._gl_loop_plain(torch.as_tensor(lm), torch.as_tensor(rand), ops, iterations,
                                 phase_bug).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-3 * scale, (np.abs(got - ref).max(), scale)
