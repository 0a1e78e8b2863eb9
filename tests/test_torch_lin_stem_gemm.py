"""The index maps of the K3 kernel (``singlehdr_tpu_torch/csrc/lin_stem.cu``),
in numpy on the CPU.

The kernel builds the 93-channel feature stack of a 16 x 16 output tile's
receptive field in shared memory, 8 channels at a time, splits each feature
once into TF32 hi/lo planes stored by column parity, and runs the 7x7/2 stem
as an implicit GEMM in 3xTF32 on ``wgmma`` (A gathered from the planes into
registers, B from a ring of packed weight slices).  CUDA does not run in the
CPU tests, so these pin what it computes: the weight packing, the bank spread
of the A gathers, the shared-memory plan, and a lane-by-lane simulation of a
launch (image staging with REFLECT, the feature rules, the planes, the gather
table, the fragment and descriptor layouts, the ring's slices and the
epilogue's edge masks) held to the plain version in float64.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from singlehdr_tpu_torch.ops.cuda import conv_gemm as cg
from singlehdr_tpu_torch.ops.cuda import lin_stem_cuda as k3
from singlehdr_tpu_torch.ops.histogram import N_FEATURES, linearization_features
from singlehdr_tpu_torch.ops.resize import same_pads

SIM_REL_TOL = 1e-6     # the simulated launch (3xTF32 products in float64) vs float64 plain
PACK_REL_TOL = 1e-6    # hi + lo planes vs the f32 weights, over K = 96 * 49
TAPS = k3.KSIZE * k3.KSIZE
SMEM_LIMIT = 232448


def _weights(seed):
    rs = np.random.RandomState(seed)
    k7 = (rs.randn(k3.OUT_F, N_FEATURES, 7, 7) * np.sqrt(2.0 / (N_FEATURES * TAPS)))
    bias = rs.randn(k3.OUT_F) * 0.1
    return k7.astype(np.float32), bias.astype(np.float32)


# --- weight packing ----------------------------------------------------------


def test_stem_weight_planes_reproduce_conv2d_over_the_built_features():
    """B's rows in the kernel's K order ((chunk, tap, channel), 93 channels
    padded to 96 with zero rows) times the im2col of the built features is the
    stride-2 SAME conv."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(2, 3, 19, 22).astype(np.float32))
    k7, _ = _weights(1)
    hi, lo = (p.double() for p in k3.stem_weight_planes(torch.from_numpy(k7)))
    assert hi.shape == (k3.CHUNKS * TAPS * k3.CHUNK, k3.OUT_F)
    assert k3.C_PAD == 96
    rows = hi.reshape(k3.CHUNKS, TAPS, k3.CHUNK, k3.OUT_F)
    flat_c = torch.arange(k3.CHUNKS)[:, None, None] * k3.CHUNK + torch.arange(k3.CHUNK)
    pad_rows = (flat_c >= N_FEATURES).expand(k3.CHUNKS, TAPS, k3.CHUNK)
    assert not rows[pad_rows].any() and not lo.reshape(rows.shape)[pad_rows].any()
    for p in (hi, lo):
        assert not (p.float().numpy().view(np.uint32) & 0x1FFF).any()
    feats = linearization_features(x).double()
    pt, pb = same_pads(19, 7, 2)
    pl, pr = same_pads(22, 7, 2)
    fp = F.pad(feats, (pl, pr, pt, pb))
    fp = F.pad(fp, (0, 0, 0, 0, 0, k3.C_PAD - N_FEATURES))
    ho, wo = 10, 11
    taps = torch.stack([fp[:, :, ky:ky + 2 * ho:2, kx:kx + 2 * wo:2]
                        for ky in range(7) for kx in range(7)], 1)  # [b, tap, c, ho, wo]
    a = taps.reshape(2, TAPS, k3.CHUNKS, k3.CHUNK, ho, wo).permute(0, 4, 5, 2, 1, 3)
    got = (a.reshape(2 * ho * wo, -1) @ (hi + lo)).reshape(2, ho, wo, -1).permute(0, 3, 1, 2)
    ref = F.conv2d(F.pad(feats, (pl, pr, pt, pb)), torch.from_numpy(k7).double(), stride=2)
    assert torch.abs(got - ref).max() <= PACK_REL_TOL * torch.abs(ref).max()


def test_pack_stem_weights_is_conv_gemms_core_matrix_layout():
    k7, _ = _weights(2)
    w = torch.from_numpy(k7)
    pk = k3.pack_stem_weights(w)
    assert pk.shape == (1, k3.CHUNKS, TAPS, 2, 8, 2, 8, 4)
    hi, lo = k3.stem_weight_planes(w)
    got = _b_from_stage(pk.numpy().reshape(-1), 5 * TAPS + 17, 1)
    np.testing.assert_array_equal(got, lo.numpy()[(5 * TAPS + 17) * 8:(5 * TAPS + 18) * 8])
    # a ring slice is one kernel row of one chunk, contiguous in the buffer
    assert pk.numel() == k3.CHUNKS * 7 * k3.SLICE_KSTEPS * 2 * k3.OUT_F * k3.CHUNK


def test_pack_stem_weights_matches_conv_gemms_packing_of_the_same_b():
    """The K3 packing is conv_gemm's core-matrix layout: for a weight whose
    conv_gemm K order equals K3's (one input channel, so (c, kh, kw) and
    (tap, channel) agree), both give the same buffer up to the zero rows."""
    w = torch.from_numpy(_weights(3)[0])
    hi, lo = k3.stem_weight_planes(w)
    rows = k3.KSIZE * k3.KSIZE * k3.CHUNK
    direct = cg.core_matrices(hi, lo, rows, k3.OUT_F)
    torch.testing.assert_close(k3.pack_stem_weights(w), direct, rtol=0, atol=0)
    one = w[:, :1].contiguous()  # [64, 1, 7, 7]: conv_plan pads its 49-deep K to 56
    bn, cc, kc_pad = cg.conv_plan(1, k3.OUT_F, 7)
    g_hi, g_lo = cg.weight_planes(one, cc, kc_pad)
    torch.testing.assert_close(g_hi[:49], hi.reshape(k3.CHUNKS, TAPS, k3.CHUNK, -1)[0, :, 0],
                               rtol=0, atol=0)
    torch.testing.assert_close(g_lo[:49], lo.reshape(k3.CHUNKS, TAPS, k3.CHUNK, -1)[0, :, 0],
                               rtol=0, atol=0)


# --- shared-memory plan and banks ----------------------------------------------


def test_plan_fits_one_block_per_sm_and_the_planes_hold_the_field():
    assert k3.smem_bytes() <= SMEM_LIMIT
    assert k3.FIELD == 37 and k3.FIELD * k3.ROW <= k3.CHANNEL_STRIDE
    # the widest gather, column 15 at tap kx = 6 (even parity), stays in its row
    assert 15 + 6 // 2 < k3.PARITY_WIDTH
    assert 15 + 5 // 2 < k3.FIELD // 2  # odd parity: 18 entries
    assert k3.CHUNKS * k3.CHUNK >= N_FEATURES > (k3.CHUNKS - 1) * k3.CHUNK


def _gather_offsets():
    """[TAPS, warp, mt, 4 registers, 32 lanes]: the plane offset each lane
    reads for a0..a3 of each k-step of a chunk."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    ks = np.arange(TAPS)
    ky, kx = ks // 7, ks % 7
    off = ky * k3.ROW + (kx & 1) * k3.PARITY_WIDTH + (kx >> 1)
    row = 2 * (np.arange(k3.WARPS)[:, None] * 2 + np.arange(2)[None, :])  # receptive row
    moff = row[..., None] * k3.ROW + g                                     # [warp, mt, lane]
    p0 = t * k3.CHANNEL_STRIDE + moff[None] + off[:, None, None, None]
    p1 = (t + 4) * k3.CHANNEL_STRIDE + moff[None] + off[:, None, None, None]
    return np.stack([p0, p0 + 8, p1, p1 + 8], 3)


def test_a_gathers_are_bank_conflict_free():
    """Each A-fragment load of a warp (a0..a3: rows g (+8), channels t (+4) of
    one tap) touches each of the 32 banks at most once: a stride-2 tap reads
    8 neighbouring words of one parity plane per channel, and the channel
    stride, 8 mod 32, puts the 4 channels on disjoint banks."""
    offs = _gather_offsets()
    for addr in offs.reshape(-1, 32):
        assert len(np.unique(addr % 32)) == len(np.unique(addr))


# --- one launch, lane by lane ------------------------------------------------


def _b_from_stage(wst, ks, plane):
    """B [8 k, 64 n] of k-step ks as wgmma reads it through the descriptor
    (no swizzle, K-major): core (n // 8, k // 4) at byte (n // 8) * 256 +
    (k // 4) * 128, element (n % 8, k % 4) at 16 bytes a row."""
    n, k = np.arange(k3.OUT_F)[None, :], np.arange(8)[:, None]
    floats = ((n // 8) * 256 + (k // 4) * 128) // 4 + (n % 8) * 4 + k % 4
    return wst[(2 * ks + plane) * k3.OUT_F * 8 + floats]


def _a_matrix(a):
    """A fragments [..., 32 lanes, 4] -> the warp's A rows [..., 16, 8]:
    a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    m = np.zeros(a.shape[:-2] + (16, 8))
    m[..., g, t], m[..., g + 8, t] = a[..., 0], a[..., 1]
    m[..., g, t + 4], m[..., g + 8, t + 4] = a[..., 2], a[..., 3]
    return m


def _split(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    hi, lo = cg.split_tf32(t)
    return hi.numpy(), lo.numpy()


def _reflect_clamp(i, n):
    i = np.where(i < 0, -i, i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def _feature(img, ch, a, b):
    """The kernel's ``feature``: channel ch at image-tile rows a, columns b
    (index arrays into img [3, 39, 39]), f32."""
    f32 = np.float32
    if ch < 3:
        return img[ch, a, b]
    if ch < 9:
        k = ch - 3
        p = img[k >> 1]
        if k % 2 == 0:
            sd = (p[a + 1, b - 1] + f32(2) * p[a + 1, b]) + p[a + 1, b + 1]
            su = (p[a - 1, b - 1] + f32(2) * p[a - 1, b]) + p[a - 1, b + 1]
            return sd - su
        sr = (p[a - 1, b + 1] + f32(2) * p[a, b + 1]) + p[a + 1, b + 1]
        sl = (p[a - 1, b - 1] + f32(2) * p[a, b - 1]) + p[a + 1, b - 1]
        return sr - sl
    j, nb = ch - 9, 4
    if j >= 12:
        j, nb = j - 12, 8
        if j >= 24:
            j, nb = j - 24, 16
    center = (f32(2) * f32(j // 3 + 1) - f32(1)) / f32(2 * nb)
    d = np.abs(img[j % 3, a, b] - center)
    return np.maximum(f32(0), f32(1) - d * f32(nb))


def simulate_launch(x, k7, bias):
    """What one ``shdr_lin_stem_f32`` launch writes, with the MMAs' products
    and sums in float64."""
    bsz, _, h, w = x.shape
    ho, wo = -(-h // 2), -(-w // 2)
    pad_t, pad_l = same_pads(h, 7, 2)[0], same_pads(w, 7, 2)[0]
    field, row, pw, cs, cc = k3.FIELD, k3.ROW, k3.PARITY_WIDTH, k3.CHANNEL_STRIDE, k3.CHUNK
    slice_floats = k3.SLICE_KSTEPS * 2 * k3.OUT_F * cc
    ring = k3.pack_stem_weights(torch.from_numpy(k7)).numpy().reshape(-1, slice_floats)
    offs = _gather_offsets()
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    out = np.full((bsz, k3.OUT_F, ho, wo), np.nan, np.float32)
    tiles_x, tiles_y = -(-wo // k3.TILE), -(-ho // k3.TILE)
    r = np.arange(field)
    for b in range(bsz):
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                oy0, ox0 = ty * k3.TILE, tx * k3.TILE
                ry0, rx0 = 2 * oy0 - pad_t, 2 * ox0 - pad_l
                gy = _reflect_clamp(ry0 - 1 + np.arange(field + 2), h)
                gx = _reflect_clamp(rx0 - 1 + np.arange(field + 2), w)
                img = x[b][:, gy][:, :, gx]
                a_idx, b_idx = np.meshgrid(r + 1, r + 1, indexing="ij")
                inside = ((ry0 + r >= 0) & (ry0 + r < h))[:, None] & \
                    ((rx0 + r >= 0) & (rx0 + r < w))[None, :]
                dest = r[:, None] * row + (r[None, :] & 1) * pw + (r[None, :] >> 1)
                acc = np.zeros((k3.WARPS, 2, 16, k3.OUT_F))
                for j in range(k3.CHUNKS):
                    feats = np.zeros((cc, field, field), np.float32)
                    for cl in range(cc):
                        if j * cc + cl < N_FEATURES:
                            v = _feature(img, j * cc + cl, a_idx, b_idx)
                            feats[cl] = np.where(inside, v, np.float32(0))
                    fhi, flo = _split(feats)
                    hi_plane = np.full(cc * cs, np.nan, np.float32)
                    lo_plane = np.full(cc * cs, np.nan, np.float32)
                    where = (np.arange(cc)[:, None, None] * cs + dest).reshape(-1)
                    hi_plane[where], lo_plane[where] = fhi.reshape(-1), flo.reshape(-1)
                    ah = _a_matrix(np.moveaxis(hi_plane[offs], 3, -1))  # [tap, warp, mt, 16, 8]
                    al = _a_matrix(np.moveaxis(lo_plane[offs], 3, -1))
                    bh = np.stack([_b_from_stage(ring[j * 7 + ks // 7], ks % 7, 0)
                                   for ks in range(TAPS)])              # [tap, 8, 64]
                    bl = np.stack([_b_from_stage(ring[j * 7 + ks // 7], ks % 7, 1)
                                   for ks in range(TAPS)])
                    acc += (np.einsum("swmrk,skn->wmrn", al, bh)
                            + np.einsum("swmrk,skn->wmrn", ah, bl)
                            + np.einsum("swmrk,skn->wmrn", ah, bh))
                # epilogue from the accumulator fragments: d[4 nt + i] is row
                # g + 8 (i >> 1), channel 8 nt + 2 t + (i & 1)
                for warp in range(k3.WARPS):
                    for mt in range(2):
                        oy = oy0 + warp * 2 + mt
                        for nt in range(k3.OUT_F // 8):
                            for i in range(4):
                                col = g + 8 * (i >> 1)
                                n = nt * 8 + 2 * t + (i & 1)
                                v = np.maximum(acc[warp, mt, col, n] + bias[n], 0)
                                ox = ox0 + col
                                m = ox < wo
                                if oy < ho:
                                    out[b, n[m], oy, ox[m]] = v[m]
    return out


@pytest.mark.parametrize("hw", [(37, 50), (40, 56), (32, 32), (33, 66)],
                         ids=["37x50", "40x56", "one_tile", "ragged_tile_row"])
def test_simulated_launch_matches_the_plain_stem(hw):
    """(32, 32) is exactly one 16 x 16 output tile; (33, 66) gives 17 x 33
    outputs, so the second tile row holds one valid row and the last tile
    column one valid column."""
    rs = np.random.RandomState(hw[0] * hw[1])
    bsz = 2 if hw == (37, 50) else 1
    x = rs.rand(bsz, 3, *hw).astype(np.float32)
    k7, bias = _weights(hw[1])
    got = simulate_launch(x, k7, bias)
    want = k3.lin_feature_stem_plain(*(torch.from_numpy(a).double() for a in (x, k7, bias)))
    want = want.numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all(), "every output element is written"
    assert np.abs(got - want).max() <= SIM_REL_TOL * np.abs(want).max()
