"""Kernels K1 and K3 (csrc/frontend_decode.cu): their host packing and their
two-level boundary scan, on the CPU at 512, 1024 and 2048 Hz, at 1152
and 1920 Hz, whose periods (288 and 96 samples) are not whole 64-row slabs,
and at 4096 and 8192 Hz, whose periods (1,024 and 2,048 samples) the
features launch walks in slabs of y through a ring of y^2 rows.

The kernels build the Toeplitz product's A operand from h = Tmat[:, 0],
read the constants as TF32 hi/lo splits, and walk the block-boundary states
as chunk-local scans, a serial carry over chunks and a fix-up with a table
of powers of A_L.  Each of those is held here to what it replaces: the
float32 Tmat is exactly Toeplitz in h; the power table is matrix_power; the
hi/lo splits reconstruct their constants in the order the kernels read
them; and a torch emulation of the two-level scan equals the sequential
scan (and the JAX package's associative one) in float64 and keeps K3's
features inside its gate in float32.  The kernels themselves are held to
the plain versions on the card in tests/test_torch_cuda.py.
"""

import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.ops import iir as j_iir

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build, cuda_frontend, iir, tf32
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params, pipeline

SRS = [512.0, 1024.0, 1152.0, 1920.0, 2048.0, 4096.0, 8192.0]
HPAD = 16  # zeros before h[0] in the kernel's shared memory
LANE = torch.arange(32)
G, Q = LANE // 4, LANE % 4  # mma fragment coordinates of a lane


@functools.lru_cache(maxsize=None)
def _decoder(sr, dtype=torch.float32, C=4):
    loaded = params.from_arrays(np.zeros((40, 9, 20)), np.zeros((40, 9)),
                                np.zeros((40, 9), np.int32), np.ones((40, 9), bool),
                                np.zeros((40, 9)), np.arange(20), [], dtype=dtype)
    cfg = pipeline.DecoderConfig(sr=sr, n_channels=C, dtype=dtype)
    return pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                         device="cpu")


def _ops(sr):
    return _decoder(sr).frontend_ops


@pytest.mark.parametrize("sr", SRS)
def test_tmat_is_toeplitz_in_h(sr):
    """The float32 Tmat (subnormals flushed) is lower triangular and constant
    along each diagonal: Tmat[t, j] = h[t - j] with h = Tmat[:, 0], so the
    kernel can read h in place of Tmat."""
    Tmat = _ops(sr).Tmat
    h = Tmat[:, 0]
    for d in range(Tmat.shape[0]):
        assert torch.equal(torch.diagonal(Tmat, -d), h[d].expand(Tmat.shape[0] - d)), d
    assert not torch.triu(Tmat, 1).any()


@pytest.mark.parametrize("sr", SRS)
def test_power_table_matches_matrix_power(sr):
    """A_L^0 .. A_L^R by repeated products in float64 equals
    torch.linalg.matrix_power to 1e-12 of its norm; the kernels' table is its
    float32 cast (subnormals flushed), and its first power is A_L itself."""
    dec = _decoder(sr)
    A = dec.filt_op.A_L.double()
    R = cuda_frontend.SCAN_CHUNK
    table = cuda_frontend.power_table(dec.filt_op.A_L, R)
    assert table.shape == (R + 1, A.shape[0], A.shape[0]) and table.dtype == torch.float64
    for i in range(R + 1):
        ref = torch.linalg.matrix_power(A, i)
        assert float((table[i] - ref).norm() / ref.norm()) < 1e-12, i
    ops = dec.frontend_ops
    assert torch.equal(ops.apow, cuda_frontend._to_f32_ftz(table))
    assert torch.equal(ops.apow[1], ops.A_L)


def _assert_hilo(hi, lo, x):
    """hi and lo are TF32 values (13 low mantissa bits clear) and hi + lo is
    x within TF32's residual, 2^-22 relative."""
    for part in (hi, lo):
        assert not (part.contiguous().view(torch.int32) & 0x1FFF).any()
    x64 = x.double()
    assert bool(((hi.double() + lo.double() - x64).abs() <= 2.0**-22 * x64.abs()).all())


@pytest.mark.parametrize("sr", SRS)
def test_toeplitz_fragments_from_h_split(sr):
    """The kernel's A fragment of Toeplitz tile (mt, kk) at lane (g, q) is
    h[d], h[d + 8], h[d - 4], h[d + 4] with d = 16 mt - 8 kk + g - q (zeros
    before h[0]): read from the hi/lo split of h in that order it gives Tmat's
    tile within TF32's residual, and every tile it skips (kk > 2 mt + 1) is 0."""
    ops = _ops(sr)
    Tmat, Ls = ops.Tmat, ops.Ls
    hi, lo = ops.h_tf32
    _assert_hilo(hi, lo, Tmat[:, 0])
    padded = torch.cat([torch.zeros(HPAD, dtype=torch.float64), hi.double() + lo.double()])
    mt = torch.arange(Ls // 16)[:, None, None]
    kk = torch.arange(Ls // 8)[None, :, None]
    d = HPAD + 16 * mt - 8 * kk + G - Q                                # (mt, kk, lane)
    tile = torch.zeros(Ls // 16, Ls // 8, 16, 8, dtype=torch.float64)
    for rows, cols, off in ((G, Q, 0), (G + 8, Q, 8), (G, Q + 4, -4), (G + 8, Q + 4, 4)):
        tile[:, :, rows, cols] = padded[d + off]
    dense = Tmat.double().reshape(Ls // 16, 16, Ls // 8, 8).permute(0, 2, 1, 3)
    kept = kk[..., 0] <= 2 * mt[..., 0] + 1                            # (mt, kk)
    assert not dense[~kept].any()
    assert bool(((tile[kept] - dense[kept]).abs() <= 2.0**-22 * dense[kept].abs()).all())


@pytest.mark.parametrize("C", [16, 13, 200, 300])
def test_lda_weight_fragments(C):
    """pack_lda_weights: lane l of k-step s, n-tile t of warp w in pass p
    holds (hi[k][n], hi[k+4][n], lo[k][n], lo[k+4][n]) of W5's row k in the
    order the epilogue stages F (by slab of 128 channels, the last one
    ragged, then tap, then channel; each tap padded to C8 = 8 ceil(C / 8)
    channels), k = 8 s + l % 4, and n = 384 p + 8 (NT w + t) + l // 4 (16
    warps of NT = 3 n-tiles a pass); the padding is 0, hi + lo is W5 within
    TF32's residual, and the 3xTF32 products from the fragments match
    float64.  C = 200 and 300 take two and three slabs."""
    M, B = 5, 40
    W, NT = cuda_frontend.LDA_WARPS, cuda_frontend.LDA_NT
    assert (W, NT, cuda_frontend.LDA_PASS, cuda_frontend.LDA_SLAB) == (16, 3, 384, 128)
    rng = np.random.RandomState(C)
    W5 = torch.as_tensor(rng.randn(M * C, 9 * B) * 0.3, dtype=torch.float32)
    packed = cuda_frontend.pack_lda_weights(W5, C, M)
    C8 = -(-C // 8) * 8
    assert packed.shape == (1, W, M * C8 // 8, NT, 32, 4)
    order = [(m, c) for c0 in range(0, C8, 128) for m in range(M) for c in range(c0, min(c0 + 128, C8))]
    s = torch.arange(M * C8 // 8)[None, :, None, None]
    k = 8 * s + Q
    n = 8 * (NT * torch.arange(W)[:, None, None, None] + torch.arange(NT)[None, None, :, None]) + G
    hi, lo = torch.zeros(M * C8, 384), torch.zeros(M * C8, 384)
    K, N = k.expand(W, -1, NT, -1), n.expand(-1, s.shape[1], -1, -1)
    hi[K, N], hi[K + 4, N], lo[K, N], lo[K + 4, N] = packed[0].unbind(-1)
    Wp = torch.zeros(M, C8, 384)
    Wp[:, :C, : 9 * B] = W5.reshape(M, C, 9 * B)
    Wp = torch.stack([Wp[m, c] for m, c in order])
    ref_hi, ref_lo = tf32.tf32_split(Wp)
    assert torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)
    _assert_hilo(hi, lo, Wp)
    assert not hi[:, 9 * B :].any() and not hi[[c >= C for _, c in order]].any()
    # the epilogue's 3xTF32 product, a_lo b_hi + a_hi b_lo + a_hi b_hi
    a = torch.as_tensor(rng.randn(64, M * C8), dtype=torch.float32)
    a_hi, a_lo = tf32.tf32_split(a)
    prod = (a_lo.double() @ hi.double() + a_hi.double() @ lo.double() + a_hi.double() @ hi.double())
    ref = a.double() @ Wp.double()
    assert float((prod - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _two_level(A_L, apow, q, s0, R):
    """States before each block (K, S, C), as the kernels walk them:
    chunk-local scans from 0 over R blocks, a serial carry over the chunks
    S_{c+1} = A_L^R S_c + (chunk c's end state), and the fix-up
    s_k = A_L^(k - cR) S_c + l_k."""
    K = q.shape[0]
    local, ends = torch.empty_like(q), []
    for c in range(-(-K // R)):
        l = torch.zeros_like(s0)
        for k in range(c * R, min(K, c * R + R)):
            local[k] = l
            l = A_L @ l + q[k]
        ends.append(l)
    carry = [s0]
    for end in ends[:-1]:
        carry.append(apow[R] @ carry[-1] + end)
    i = torch.arange(K)
    return torch.einsum("kst,ktc->ksc", apow[i % R], torch.stack(carry)[i // R]) + local


def _scan_inputs(sr, dtype, K=150, C=5):
    """q = Pmat u for K blocks of seeded sEEG (K not a whole number of chunks)
    and the warm-started initial state, in ``dtype``."""
    dec = _decoder(sr)
    ops = dec.frontend_ops
    rng = np.random.RandomState(int(sr))
    x = torch.as_tensor(rng.randn(K * ops.Ls, C), dtype=dtype)
    u = x.reshape(K, ops.Ls, C)
    q = torch.einsum("sl,klc->ksc", ops.Pmat.to(dtype), u)
    s0 = pipeline._initial_state(dec, x).to(dtype)
    return ops, x, q, s0


def _chunk(ops, K, chunk):
    """The chunk length of the test: the table's longest, or the one the
    kernels take for K periods (13 for the 150 here)."""
    return cuda_frontend.SCAN_CHUNK if chunk == "longest" else cuda_frontend.scan_chunk(ops, K)


@pytest.mark.parametrize("chunk", ["longest", "chosen"])
@pytest.mark.parametrize("sr", SRS)
def test_two_level_scan_equals_sequential_f64(sr, chunk):
    """float64: the two-level scan equals the sequential walk
    (iir._boundary_states) and the JAX package's associative scan to 1e-10
    of the states' scale, with chunks of SCAN_CHUNK periods and of the
    length the kernels choose for this input."""
    ops, _, q, s0 = _scan_inputs(sr, torch.float64)
    A = ops.A_L.double()
    R = _chunk(ops, q.shape[0], chunk)
    two = _two_level(A, cuda_frontend.power_table(A, R), q, s0, R)
    seq, _ = iir._boundary_states(A, q, s0)
    jax_seq, _ = j_iir._boundary_states(jnp.asarray(A.numpy()), jnp.asarray(q.numpy()),
                                        jnp.asarray(s0.numpy()))
    scale = float(seq.abs().max())
    assert float((two - seq).abs().max()) <= 1e-10 * scale
    assert float((two - torch.as_tensor(np.array(jax_seq))).abs().max()) <= 1e-10 * scale


@pytest.mark.parametrize("chunk", ["longest", "chosen"])
@pytest.mark.parametrize("sr", SRS)
def test_two_level_scan_f32_within_k3_reach(sr, chunk):
    """float32 with the kernels' float32 power table: the block outputs'
    state part Cpow s_k stays as close to float64 as the sequential f32 walk
    (p99.9 within 2x), and the log-power features computed from its states
    stay within K3's gate (1e-4) of the plain version's; with chunks of
    SCAN_CHUNK periods and of the length the kernels choose."""
    ops, x, q, s0 = _scan_inputs(sr, torch.float32)
    R = _chunk(ops, q.shape[0], chunk)
    two = _two_level(ops.A_L, ops.apow, q, s0, R)
    seq, _ = iir._boundary_states(ops.A_L, q, s0)
    _, _, q64, s064 = _scan_inputs(sr, torch.float64)
    ref, _ = iir._boundary_states(ops.A_L.double(), q64, s064)
    y = lambda s: torch.einsum("ls,ksc->klc", ops.Cpow.double(), s.double())
    err_two = (y(two) - y(ref)).abs().flatten().quantile(0.999)
    err_seq = (y(seq) - y(ref)).abs().flatten().quantile(0.999)
    assert float(err_two) <= 2 * float(err_seq), (float(err_two), float(err_seq))

    def features(s_before):
        K, Ls, C = q.shape[0], ops.Ls, x.shape[1]
        u = x.reshape(K, Ls, C)
        yk = torch.einsum("ls,ksc->klc", ops.Cpow, s_before) + torch.einsum("tj,kjc->ktc", ops.Tmat, u)
        prev = torch.cat([ops.prefix[None, :, None].expand(1, Ls, C), yk[:-1]], dim=0)
        span = torch.cat([prev, yk], dim=1)
        return torch.log(torch.einsum("pt,ktc->kpc", ops.S_win, span * span) + 0.01)

    assert float((features(two) - features(seq)).abs().max()) < 1e-4


def _slab_rows():
    """features_slab_kernel's rows of y a slab (YROWS in the CUDA source)."""
    src = (_build.CSRC / "frontend_decode.cu").read_text()
    return int(re.search(r"constexpr int YROWS = (\d+);", src).group(1))


def _slab_logpower(ops, x, s0, n_frames, run=16):
    """Log-power rows as features_slab_kernel orders its work, in float64:
    runs of ``run`` periods; per period y_k in slabs of SLAB_ROWS rows
    written to a ring of SLAB_ROWS + max(tail, win) rows (H, as the launch
    sizes it; NaN until written) at row
    ((k - k0 + 1) Ls + r) % H; after each slab the windows whose last row it
    wrote, read back from the ring; the run's first period writes only the
    rows the windows reach (the prefix at k0 = 0).  Returns the rows and how
    often each was written."""
    Ls, P, win, tail, R = ops.Ls, ops.P, ops.win, ops.tail, _slab_rows()
    H = R + max(tail, win)
    Kp, C = -(-n_frames // P), x.shape[1]
    u = torch.nn.functional.pad(x, (0, 0, 0, Kp * Ls - x.shape[0])).reshape(Kp, Ls, C)
    A, Pm = ops.A_L.double(), ops.Pmat.double()
    s_before, _ = iir._boundary_states(A, torch.einsum("sl,klc->ksc", Pm, u), s0)
    y = (torch.einsum("ls,ksc->klc", ops.Cpow.double(), s_before)
         + torch.einsum("tj,kjc->ktc", ops.Tmat.double(), u))
    starts = ops.starts.tolist()
    F = torch.full((Kp * P, C), float("nan"), dtype=torch.float64)
    written = torch.zeros(Kp * P, dtype=torch.int64)
    for k0 in range(0, Kp, run):
        ring = torch.full((H, C), float("nan"), dtype=torch.float64)
        if k0 == 0:
            rows = torch.arange(Ls - tail, Ls)
            ring[rows % H] = (ops.prefix.double()[rows] ** 2)[:, None].expand(-1, C)
        for k in range(max(k0 - 1, 0), min(Kp, k0 + run)):
            pre = k < k0
            ylo, base = (Ls - tail if pre else 0), (k - k0 + 1) * Ls
            for m0 in range(ylo // R * R, Ls, R):
                rows = torch.arange(max(m0, ylo), min(m0 + R, Ls))
                ring[(base + rows) % H] = y[k, rows] ** 2
                if pre:
                    continue
                hi = Ls + min(m0 + R, Ls)
                for fi, st in enumerate(starts):
                    e = st + win
                    if e > hi or (m0 > 0 and e <= Ls + m0):
                        continue
                    idx = ((k - k0) * Ls + st + torch.arange(win)) % H
                    F[k * P + fi] = torch.log(ring[idx].sum(0) + 0.01)
                    written[k * P + fi] += 1
    return F[:n_frames], written[:n_frames]


@pytest.mark.parametrize("sr", SRS)
def test_slab_walk_matches_plain_f64(sr):
    """features_slab_kernel's order of work (slabs of y, the ring of
    YROWS + max(tail, win) rows, each window summed after the slab with
    its last row, the recomputed tail of y_{k0-1} at each run's start) gives
    the plain version's features in float64 to 1e-12, each window once: no
    window reads a row the ring has not been given or has already dropped.
    40 periods are two runs of 16 and a ragged one; the kernel takes this
    path above 512 samples (4096 and 8192 Hz), the walk holds at every rate."""
    dec = _decoder(sr, torch.float64)
    ops = dec.frontend_ops
    rng = np.random.RandomState(int(sr) + 1)
    x = torch.as_tensor(rng.randn(40 * ops.Ls - 77, 3))
    nf = len(pipeline.framing.streaming_frame_ends(50, 10, sr, x.shape[0] + len(dec.zf_prefix)))
    s0 = pipeline._initial_state(dec, x)
    F, written = _slab_logpower(ops, x, s0, nf)
    ref = cuda_frontend.frontend_logpower_plain(ops, x, s0, nf)
    assert torch.equal(written, torch.ones_like(written))
    assert float((F - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_long_periods_take_the_slab_launches():
    """The periods the single-slab launches hold in shared memory end at 512
    samples (2048 Hz); 4096 and 8192 Hz (1,024 and 2,048) take the streamed
    launches, up to the JAX package's longest period, 2,048 (MAX_LS)."""
    assert _ops(2048.0).Ls == 512 < _ops(4096.0).Ls == 1024 < _ops(8192.0).Ls == 2048
    assert cuda_frontend.MAX_LS == 2048 and _slab_rows() == 256


def test_serial_scan_steps():
    """The kernels' scan takes R chunk-local steps and ceil(Kp / R) - 1 carry
    steps, at most Kp / R + R: 176 at 30 min / 1024 Hz (Kp = 7,200, R =
    SCAN_CHUNK); R = ceil(sqrt(Kp)) below 3,970 periods (exp1's 30 s fold:
    120 periods, chunks of 11, 21 steps instead of 64)."""
    ops = _ops(1024.0)
    R = cuda_frontend.SCAN_CHUNK
    assert cuda_frontend.serial_scan_steps(ops, 7200) == R + 113 - 1 == 176 <= 7200 / R + R
    chosen = {1: 1, 2: 2, 16: 4, 17: 5, 120: 11, 3969: 63, 3970: 64, 7200: 64}
    assert {Kp: cuda_frontend.scan_chunk(ops, Kp) for Kp in chosen} == chosen
    assert cuda_frontend.serial_scan_steps(ops, 120) == 11 + 11 - 1
    for Kp in (1, 17, R, R + 1, 4 * R - 3, 7200, 14400):
        steps = cuda_frontend.serial_scan_steps(ops, Kp)
        assert steps <= Kp and steps <= Kp / R + R


def test_build_digest_covers_headers(tmp_path):
    """A library is named by its source, the headers in csrc/ and the flags:
    editing or adding a header rebuilds every source, as editing the source
    does; the package's own digest covers tf32_mma.cuh."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    d0 = _build.digest("k", tmp_path)
    assert _build.digest("k", tmp_path) == d0
    (tmp_path / "h.cuh").write_text("// two\n")
    d1 = _build.digest("k", tmp_path)
    (tmp_path / "g.cuh").write_text("// new\n")
    d2 = _build.digest("k", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    d3 = _build.digest("k", tmp_path)
    assert len({d0, d1, d2, d3}) == 4
    assert (_build.CSRC / "tf32_mma.cuh").exists()
    import hashlib
    only_cu = hashlib.sha256((_build.CSRC / "frontend_decode.cu").read_bytes()
                             + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:12]
    assert _build.digest("frontend_decode") != only_cu


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("frontend_kernel_probe",
                                                  ROOT / "frontend_kernel_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_probe_variants_edit_only_what_they_name(probe):
    """frontend_kernel_probe.py's variants of csrc/frontend_decode.cu and
    tf32_mma.cuh: the mma variants change only mma3 in the header, or only
    the LDA epilogue's product in the source; the stamped copy adds the stamps to features_kernel and chunk_scan_kernel
    (seven and three phases) and a reader, and nothing else."""
    src, header = (ROOT / probe.SRC).read_text(), (ROOT / probe.HEADER).read_text()
    builds = probe.variants(src, header)
    assert builds["as built"] == (src, header)
    for name, (old, new) in probe.HEADER_EDITS.items():
        assert builds[name][0] == src and builds[name][1].replace(new, old) == header
    lda = src.index(" lda_epilogue_kernel(")
    for name, (old, new) in probe.SOURCE_EDITS.items():  # inside lda_epilogue_kernel only
        assert builds[name][1] == header and builds[name][0].replace(new, old) == src
        assert lda < src.index(old) < src.index("\n}\n", lda)
    stamped = builds["stamped"][0]
    assert stamped.count("atomicAdd(&probe_cycles[") == 11
    body = stamped[stamped.index(" features_kernel("):]
    assert body.index("probe_cycles[7]") < body.index(" lda_epilogue_kernel(")
    for anchor, before, after in probe.STAMPS:
        stamped = stamped.replace(before + anchor + after, anchor)
    assert stamped == src + probe.READ


def test_probe_refuses_a_source_without_its_anchors(probe):
    src, header = (ROOT / probe.SRC).read_text(), (ROOT / probe.HEADER).read_text()
    with pytest.raises(ValueError, match="anchor"):
        probe.variants(src, header.replace(probe.MMA3, ""))
    with pytest.raises(ValueError, match="anchor"):
        probe.variants(src.replace(probe.STAMPS[1][0], ""), header)
    with pytest.raises(ValueError, match="anchor"):
        probe.variants(src.replace(probe.LDA_MMA3, ""), header)
