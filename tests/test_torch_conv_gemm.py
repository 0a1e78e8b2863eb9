"""The arithmetic and index maps of the K2/K4 conv kernel
(``singlehdr_tpu_torch/csrc/conv2_pool.cu``), in numpy on the CPU.

The kernel is an implicit GEMM on the tensor cores in 3xTF32 (``wgmma``
m64nNk8 tf32, A from registers, B from shared memory).  CUDA does not run in
the CPU tests, so these pin what it computes: TF32 rounding on the bit pattern, why
three products are needed, the wrapper's weight packing (hi/lo planes, K
padded to 8, the descriptor's core-matrix layout), and a lane-by-lane
simulation of one launch — the staged tile with its halo, the k -> offset
table, the A fragment and accumulator maps, and both pool epilogues — held to
the plain PyTorch stage.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from singlehdr_tpu_torch.ops.cuda import conv_gemm as cg
from singlehdr_tpu_torch.ops.cuda.enc_pool_cuda import encoder_stage2_plain
from singlehdr_tpu_torch.ops.cuda.unet_stage_cuda import unet_stage2_plain

GEMM_REL_TOL = 1e-5    # 3xTF32 (and a numpy GEMM over the planes) vs float64
TF32_1X_FLOOR = 1e-4   # a single TF32 product misses the kernels' 1e-4 bound
SIM_REL_TOL = 1e-5     # the simulated launch vs the plain stage in float64


def _np_round_tf32(x):
    """Independent reference: nearest value with 11 significant bits, ties
    away from zero, from frexp (not from the bit pattern)."""
    m, e = np.frexp(x.astype(np.float64))
    q = m * 2.0 ** 11
    q = np.sign(q) * np.floor(np.abs(q) + 0.5)
    return np.ldexp(q, e - 11).astype(np.float32)


def _tf32(a):
    return cg.round_tf32(torch.from_numpy(np.ascontiguousarray(a, np.float32))).numpy()


def _split(a):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


# --- TF32 rounding -----------------------------------------------------------


def test_round_tf32_is_rna_on_the_bit_pattern():
    rs = np.random.RandomState(0)
    x = (rs.randn(20000) * np.exp(rs.uniform(-20, 20, 20000))).astype(np.float32)
    # exact ties: the 13 dropped bits are 1000000000000b, both signs
    bits = (rs.randint(0, 2**10, 2000).astype(np.uint32) << 13) | 0x1000
    bits |= rs.randint(100, 150, 2000).astype(np.uint32) << 23
    ties = bits.view(np.float32)
    x = np.concatenate([x, ties, -ties, np.float32([0.0, 1.0, -2.5, 1e-30])])
    r = _tf32(x)
    assert not (r.view(np.uint32) & 0x1FFF).any(), "low 13 mantissa bits must be zero"
    np.testing.assert_array_equal(r, _np_round_tf32(x))
    assert np.all(np.abs(r - x) <= np.abs(x) * 2.0 ** -11)
    # a tie rounds away from zero
    assert np.all(np.abs(_tf32(ties)) > np.abs(ties))
    assert np.all(np.abs(_tf32(-ties)) > np.abs(ties))


@pytest.mark.parametrize("k", [128 * 9, 16 * 49, 93 * 49], ids=["enc2_K1152", "stem_K784", "lin_stem_K4557"])
def test_3xtf32_reaches_f32_accuracy_and_1xtf32_does_not(k):
    rs = np.random.RandomState(k)
    a = rs.rand(4096, k).astype(np.float32)                     # activations in [0, 1]
    b = (rs.randn(k, 128) * np.sqrt(2.0 / k)).astype(np.float32)  # He-scaled weights
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    (ah, al), (bh, bl) = _split(a), _split(b)
    three = al @ bh + ah @ bl + ah @ bh  # f32 sums of exact TF32 products
    one = ah @ bh
    f32 = a @ b
    err3 = np.abs(three - ref).max() / scale
    err1 = np.abs(one - ref).max() / scale
    assert err3 <= GEMM_REL_TOL, err3
    assert err1 > TF32_1X_FLOOR, err1
    assert err3 <= 4 * np.abs(f32 - ref).max() / scale  # as good as plain f32


# --- weight packing ----------------------------------------------------------


def _im2col(x, cc, kc_pad, k):
    """[B, C, H, W] -> [B*H*W, chunks*kc_pad] in the kernel's K order, SAME padding."""
    bsz, c, h, w = x.shape
    r = k // 2
    xp = np.pad(x, ((0, 0), (0, 0), (r, r), (r, r)))
    taps = np.stack([xp[:, :, kh:kh + h, kw:kw + w] for kh in range(k) for kw in range(k)], 2)
    taps = taps.reshape(bsz, c // cc, cc * k * k, h, w)
    taps = np.pad(taps, ((0, 0), (0, 0), (0, kc_pad - cc * k * k), (0, 0), (0, 0)))
    return taps.reshape(bsz, -1, h * w).transpose(0, 2, 1).reshape(bsz * h * w, -1)


@pytest.mark.parametrize("c,f,k", [(3, 64, 3), (9, 16, 7), (3, 16, 7), (16, 32, 5), (64, 128, 3)])
def test_weight_planes_and_im2col_reproduce_conv2d(c, f, k):
    rs = np.random.RandomState(c * k)
    x = rs.rand(2, c, 11, 13).astype(np.float32)
    w = (rs.randn(f, c, k, k) * np.sqrt(2.0 / (c * k * k))).astype(np.float32)
    bn, cc, kc_pad = cg.conv_plan(c, f, k)
    assert kc_pad % 8 == 0 and cc * k * k <= kc_pad < cc * k * k + 8
    if c % 8:
        assert cc == c  # one chunk, its K padded: 27 -> 32, 147 -> 152, 441 -> 448
    hi, lo = (p.numpy() for p in cg.weight_planes(torch.from_numpy(w), cc, kc_pad))
    assert hi.shape == lo.shape == ((c // cc) * kc_pad, f)
    for p in (hi, lo):
        assert not (p.view(np.uint32) & 0x1FFF).any()
        assert not p.reshape(c // cc, kc_pad, f)[:, cc * k * k:].any()
    got = _im2col(x, cc, kc_pad, k).astype(np.float64) @ (hi.astype(np.float64) + lo)
    got = got.reshape(2, 11, 13, f).transpose(0, 3, 1, 2)
    ref = F.conv2d(torch.from_numpy(x).double(), torch.from_numpy(w).double(), padding=k // 2)
    ref = ref.numpy()
    assert np.abs(got - ref).max() <= GEMM_REL_TOL * np.abs(ref).max()


def _b_from_stage(wst, ks, plane, bn):
    """B [8 k, bn n] of k-step ks as wgmma reads it from the staged weights
    through the descriptor (no swizzle, K-major): core (n // 8, k // 4) at
    byte (n // 8) * SBO + (k // 4) * LBO, element (n % 8, k % 4) at 16 B a row."""
    lead, stride = 128, 256  # csrc/conv2_pool.cu kLeadBytes, kStrideBytes
    n, k = np.arange(bn)[None, :], np.arange(8)[:, None]
    floats = ((n // 8) * stride + (k // 4) * lead) // 4 + (n % 8) * 4 + k % 4
    return wst[(2 * ks + plane) * bn * 8 + floats]


@pytest.mark.parametrize("c,f,k", [(3, 64, 3), (9, 16, 7), (32, 32, 5), (64, 128, 3)])
def test_pack_weights_is_the_wgmma_b_layout(c, f, k):
    """Reading the packed buffer the way ``wgmma`` does, through the kernel's
    descriptor strides, gives back both planes."""
    rs = np.random.RandomState(f + k)
    w = torch.from_numpy(rs.randn(f, c, k, k).astype(np.float32))
    bn, cc, kc_pad = cg.conv_plan(c, f, k)
    hi, lo = (p.numpy() for p in cg.weight_planes(w, cc, kc_pad))
    pk = cg.pack_weights(w).numpy()
    chunks = c // cc
    assert pk.shape == (f // bn, chunks, kc_pad // 8, 2, bn // 8, 2, 8, 4)
    stages = pk.reshape(f // bn, chunks, -1)
    for nblk in range(f // bn):
        for j in range(chunks):
            for ks in range(kc_pad // 8):
                rows = slice(j * kc_pad + 8 * ks, j * kc_pad + 8 * ks + 8)
                cols = slice(nblk * bn, (nblk + 1) * bn)
                for plane, want in ((0, hi), (1, lo)):
                    got = _b_from_stage(stages[nblk, j], ks, plane, bn)
                    np.testing.assert_array_equal(got, want[rows, cols])


# --- one launch, lane by lane ------------------------------------------------


def _wgmma_rows(a, b):
    """One warp's 16 rows of ``wgmma`` m64nNk8 with A from registers.
    a [MT, 32, 4] (a0..a3 of each lane), b [8, N] -> the accumulator
    fragment [MT, 32, N / 2], via the PTX maps: a0 (g, t), a1 (g + 8, t),
    a2 (g, t + 4), a3 (g + 8, t + 4); d[4 nt + i] (g + 8 (i >> 1), 8 nt + 2t + (i & 1))."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    am = np.zeros(a.shape[:-2] + (16, 8))
    am[..., g, t], am[..., g + 8, t] = a[..., 0], a[..., 1]
    am[..., g, t + 4], am[..., g + 8, t + 4] = a[..., 2], a[..., 3]
    cm = am @ b  # [MT, 16, N]
    n = b.shape[1]
    d = np.empty(a.shape[:-2] + (32, n // 2))
    for nt in range(n // 8):
        for i in range(4):
            d[..., 4 * nt + i] = cm[..., g + 8 * (i >> 1), 8 * nt + 2 * t + (i & 1)]
    return d


def _mma_sync_rows(a, b0, b1):
    """``mma.sync`` m16n8k8 tf32 (the BN = 16 path): a [MT, 32, 4] (the same A
    map as above), b0/b1 [32] (b0 (k t, n g), b1 (k t + 4, n g)) -> the D
    fragment [MT, 32, 4]: d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    bm = np.zeros((8, 8))
    bm[t, g], bm[t + 4, g] = b0, b1
    return _wgmma_rows(a, bm)


def simulate_launch(x, w, bias, mode):
    """What one ``shdr_conv_gemm_f32`` launch writes: (out, pooled or None)."""
    bsz, c, h, wd = x.shape
    f, _, k, _ = w.shape
    bn, cc, kc_pad = cg.conv_plan(c, f, k)
    tile, r = cg.TILE, k // 2
    side = tile + k - 1
    n_warps = cg.WARPS
    mt_n, nt_n = tile // n_warps, bn // 8
    chunks, ksteps, kvalid = c // cc, kc_pad // 8, cc * k * k
    cs = cg.channel_stride(k)
    in_floats = cc * cs
    zero = tile * side if kvalid < kc_pad else 0
    kk = np.arange(kc_pad)
    koff = np.where(kk < kvalid, (kk // (k * k)) * cs + (kk % (k * k)) // k * side + kk % k,
                    in_floats)
    wpk = cg.pack_weights(torch.from_numpy(w)).numpy().reshape(f // bn, chunks, -1)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    pool = mode in (cg.LEAKY_AVG_POOL, cg.RELU_MAX_POOL)
    leaky = mode in (cg.LEAKY_STORE, cg.LEAKY_AVG_POOL)
    ph, pw = ((h // 2, wd // 2) if mode == cg.LEAKY_AVG_POOL else ((h + 1) // 2, (wd + 1) // 2))
    out = np.full((bsz, f, h, wd), np.nan, np.float32)
    pooled = np.full((bsz, f, ph, pw), np.nan, np.float32) if pool else None
    tiles_x, tiles_y = -(-wd // tile), -(-h // tile)
    i = np.arange(cc * side * side)
    ci, ri = i // (side * side), i % (side * side)
    for b in range(bsz):
        for nblk in range(f // bn):
            for tyi in range(tiles_y):
                for txi in range(tiles_x):
                    ty0, tx0 = tyi * tile, txi * tile
                    acc = np.zeros((n_warps, mt_n, 32, bn // 2), np.float32)
                    for j in range(chunks):
                        # the stage: input tile + halo (zero-fill outside), zero rows
                        stage = np.zeros(in_floats + zero, np.float32)
                        gy, gx = ty0 - r + ri // side, tx0 - r + ri % side
                        ok = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < wd)
                        stage[ci[ok] * cs + ri[ok]] = x[b, j * cc + ci[ok], gy[ok], gx[ok]]
                        wst = wpk[nblk, j]
                        for warp in range(n_warps):
                            moff = (warp * mt_n + np.arange(mt_n))[:, None] * side + g
                            for ks in range(ksteps):
                                k0, k1 = koff[ks * 8 + t], koff[ks * 8 + t + 4]
                                a = np.stack([stage[moff + k0], stage[moff + 8 + k0],
                                              stage[moff + k1], stage[moff + 8 + k1]], -1)
                                ah, al = _split(a)
                                if bn == 16:  # mma.sync: b0/b1 at lane-consecutive floats
                                    d = np.zeros((mt_n, 32, bn // 2))
                                    for nt in range(nt_n):
                                        hi = wst[2 * ks * bn * 8 + 64 * nt + lane + np.array([[0], [32]])]
                                        lo = wst[(2 * ks + 1) * bn * 8 + 64 * nt + lane
                                                 + np.array([[0], [32]])]
                                        d[..., 4 * nt:4 * nt + 4] = (
                                            _mma_sync_rows(al, *hi) + _mma_sync_rows(ah, *lo)
                                            + _mma_sync_rows(ah, *hi))
                                else:
                                    bh = _b_from_stage(wst, ks, 0, bn)
                                    bl = _b_from_stage(wst, ks, 1, bn)
                                    d = (_wgmma_rows(al, bh) + _wgmma_rows(ah, bl)
                                         + _wgmma_rows(ah, bh))
                                acc[warp] += d.astype(np.float32)
                    # epilogue
                    for warp in range(n_warps):
                        n0 = nblk * bn
                        vals = np.empty((mt_n, nt_n, 32, 4), np.float32)
                        for mt in range(mt_n):
                            y = ty0 + warp * mt_n + mt
                            for nt in range(nt_n):
                                for q in range(4):
                                    xx = tx0 + g + 8 * (q >> 1)
                                    n = n0 + nt * 8 + 2 * t + (q & 1)
                                    v = acc[warp, mt, :, 4 * nt + q] + bias[n]
                                    v = np.where(v > 0, v, v * np.float32(0.1)) if leaky \
                                        else np.maximum(v, 0)
                                    vals[mt, nt, :, q] = v
                                    if y < h:
                                        m = xx < wd
                                        out[b, n[m], y, xx[m]] = v[m]
                        if not pool:
                            continue
                        partner = lane ^ 4  # column pair: lane g ^ 1
                        for mt in range(0, mt_n, 2):
                            y = ty0 + warp * mt_n + mt
                            for nt in range(nt_n):
                                for q in range(4):
                                    xx = tx0 + g + 8 * (q >> 1)
                                    top, bot = vals[mt, nt, :, q], vals[mt + 1, nt, :, q]
                                    if mode == cg.RELU_MAX_POOL:
                                        top = np.where((y < h) & (xx < wd), top, -np.inf)
                                        bot = np.where((y + 1 < h) & (xx < wd), bot, -np.inf)
                                        v = np.maximum(top, bot)
                                        v = np.maximum(v, v[partner])
                                    else:
                                        v = top + bot
                                        v = (v + v[partner]) * np.float32(0.25)
                                    py, px = y // 2, xx // 2
                                    m = ((g & 1) == 0) & (px < pw)
                                    n = n0 + nt * 8 + 2 * t + (q & 1)
                                    if py < ph:
                                        pooled[b, n[m], py, px[m]] = v[m]
    return out, pooled


STAGES = [
    # (kernel, x shape, F, k): odd sizes give ragged tiles and the ceil edge of
    # the max pool; C = 3 and 9 are one padded chunk, C = 16..64 a ring of chunks
    ("encoder_stage2", (1, 3, 19, 21), 64, 3),
    ("encoder_stage2", (1, 64, 17, 18), 128, 3),
    ("unet_stage2", (1, 9, 18, 20), 16, 7),
    ("unet_stage2", (2, 16, 17, 16), 32, 5),
]


@pytest.mark.parametrize("kernel,shape,f,k", STAGES,
                         ids=[f"{s[0]}_{s[1][1]}to{s[2]}_k{s[3]}" for s in STAGES])
def test_simulated_launches_match_the_plain_stage(kernel, shape, f, k):
    rs = np.random.RandomState(f * k)
    c = shape[1]
    x = (rs.rand(*shape) * 2 - 0.5).astype(np.float32)
    w1 = (rs.randn(f, c, k, k) * np.sqrt(2.0 / (c * k * k))).astype(np.float32)
    w2 = (rs.randn(f, f, k, k) * np.sqrt(2.0 / (f * k * k))).astype(np.float32)
    b1, b2 = (rs.randn(f) * 0.1).astype(np.float32), (rs.randn(f) * 0.1).astype(np.float32)
    if kernel == "unet_stage2":
        plain, modes = unet_stage2_plain, (cg.LEAKY_STORE, cg.LEAKY_AVG_POOL)
    else:
        plain, modes = encoder_stage2_plain, (cg.RELU_STORE, cg.RELU_MAX_POOL)
    mid, none = simulate_launch(x, w1, b1, modes[0])
    assert none is None
    act, pooled = simulate_launch(mid, w2, b2, modes[1])
    want_pool, want_act = (t.numpy() for t in plain(*(torch.from_numpy(a).double() for a in
                                                       (x, w1, b1, w2, b2))))
    for got, want in ((act, want_act), (pooled, want_pool)):
        assert got.shape == want.shape
        assert np.isfinite(got).all(), "every output element is written"
        assert np.abs(got - want).max() <= SIM_REL_TOL * np.abs(want).max()


def test_main_path_stages_fit_the_kernel():
    """Every conv the serving path hands K2/K4 (and phase 3's odd K4 case) has
    a plan within the shared-memory limit, with the ring of 3 stages wherever
    the layer has 3 chunks or more."""
    convs = [(3, 16, 7), (9, 16, 7), (16, 16, 7), (16, 32, 5), (32, 32, 5), (32, 64, 3),
             (64, 64, 3), (3, 64, 3), (64, 128, 3), (128, 128, 3)]
    for c, f, k in convs:
        assert cg.supported(c, f, k) is None, (c, f, k)
        bn, cc, _ = cg.conv_plan(c, f, k)
        assert f % bn == 0 and c % cc == 0
    assert cg.supported(3, 24, 3) is not None  # 24 channels: no N tile divides it


MAIN_PATH_CONVS = [(3, 16, 7), (9, 16, 7), (16, 16, 7), (16, 32, 5), (32, 32, 5), (32, 64, 3),
                   (64, 64, 3), (3, 64, 3), (64, 128, 3), (128, 128, 3)]


@pytest.mark.parametrize("c,f,k", MAIN_PATH_CONVS)
def test_a_fragment_loads_are_bank_conflict_free(c, f, k):
    """Each A-fragment load of a warp (lanes g, t: row g (+8), k-column t (+4))
    touches 32 banks at most once per distinct address, given the padded
    channel stride of the staged tile."""
    bn, cc, kc_pad = cg.conv_plan(c, f, k)
    side, cs = cg.TILE + k - 1, cg.channel_stride(k)
    kk = np.arange(kc_pad)
    koff = np.where(kk < cc * k * k, kk // (k * k) * cs + kk % (k * k) // k * side + kk % k,
                    cc * cs)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for row in range(cg.TILE):
        for ks in range(kc_pad // 8):
            for col in (koff[ks * 8 + t], koff[ks * 8 + t + 4]):
                for half in (0, 8):
                    addr = np.unique(row * side + g + half + col)
                    assert len(np.unique(addr % 32)) == len(addr), (row, ks)


def test_packed_weights_are_cached_until_the_weight_changes():
    w = torch.randn(16, 3, 7, 7)
    first = cg.packed_weights(w)
    assert cg.packed_weights(w) is first
    w.mul_(2)  # in place: the version counter moves
    again = cg.packed_weights(w)
    assert again is not first
    torch.testing.assert_close(again, cg.pack_weights(w), rtol=0, atol=0)
    with torch.inference_mode():
        frozen = torch.randn(16, 3, 7, 7)
    assert cg.packed_weights(frozen) is not cg.packed_weights(frozen)
