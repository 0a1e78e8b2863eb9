"""The shared launch of K2 and K4: one SAME conv as an implicit GEMM on the
tensor cores (``csrc/conv2_pool.cu``), in 3xTF32 for f32 tensors and in one
bf16 product for bf16 tensors, and the weight packing it reads.

The kernel's GEMM has M = the output pixels of a tile, N = ``bn`` output
channels per block, K = C*k*k walked in chunks of ``cc`` input channels, each
chunk's K zero-padded to ``kc_pad``, a multiple of the MMA's k-step.

f32: TILE x TILE tiles, K in (c, kh, kw) order, chunks of 8 channels (C = 3
or 9: one chunk), k-steps of 8.  bf16: K in (kh, kw, c) order, chunks of 16
channels staged as two planes of 8 (C <= 4: one plane whose rows hold 4
channels of two neighbouring pixels, so a k half is two taps; C = 9: one
chunk of two planes), k-steps of 16 (one tap x 16 channels, or four taps x
4); ``weight_rows_bf16``.  The bf16 conv1 stores its
activation channel-blocked, [B, F/8, H, W, 8], which conv2 reads
(``mid_like``).

B is laid out as ``wgmma`` reads it from shared memory: per (N block, chunk,
k-step, plane), K-major core matrices of 8 n x 16 bytes, the core (n8 group
ng, k half kc) at byte 128 * (2 * ng + kc), n at 16 * (n % 8).  In f32 a core
is 8 n x 4 k and there are two planes, hi = rna_tf32(w) and lo =
rna_tf32(w - hi); in bf16 a core is 8 n x 8 k and the one plane is the
weight rounded to bf16 once (the caller's bf16 tensor).
"""

from __future__ import annotations

import torch

from singlehdr_tpu_torch.ops.cuda import _build
from singlehdr_tpu_torch.ops.cuda._check import ptr, stream

TILE = 16  # f32 output tile side (TH = TW in csrc/conv2_pool.cu)
WARPS = 8  # 2 warpgroups; f32: a warp 2 tile rows x all bn channels
STAGES = 3
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use (common.cuh)
SM_SMEM = 233472     # shared memory of one SM; each resident block also takes 1 KB
BLOCK_RESERVED = 1024

ENTRY = {torch.float32: "shdr_conv_gemm_f32", torch.bfloat16: "shdr_conv_gemm_bf16"}

# bf16 (csrc/conv2_pool.cu, the bf16 section)
RING_BF16 = 3       # ring slots
TILE_COLS_BF16 = 16
BLOCKS_PER_SM_BF16 = 2  # __launch_bounds__

# epilogues (csrc/conv2_pool.cu Mode)
LEAKY_STORE, LEAKY_AVG_POOL, RELU_STORE, RELU_MAX_POOL = range(4)


def conv_plan(c: int, f: int, k: int, dtype=torch.float32) -> tuple[int, int, int]:
    """(bn, cc, kc_pad): output channels per block, input channels per chunk,
    and the chunk's K padded to a multiple of the k-step (f32: 8; bf16: 16,
    ``16 * ksteps_bf16``)."""
    bn = f if f in (16, 32) else 64
    if dtype == torch.bfloat16:
        cc = 4 if c <= 4 else 16
        return bn, cc, 16 * ksteps_bf16(k, 2 if cc == 16 else 1)
    cc = 8 if c % 8 == 0 else c
    kc_pad = -(-cc * k * k // 8) * 8
    return bn, cc, kc_pad


def channel_stride(k: int) -> int:
    """Floats between two channels of the f32 staged input tile: side^2 + k + 7,
    a bank-spread pad."""
    side = TILE + k - 1
    return side * side + k + 7


def ksteps_bf16(k: int, planes: int) -> int:
    """bf16 k-steps of a chunk: one a tap with two planes (16 channels); with
    one plane (pixel pairs x 4 channels), four taps of a kernel row each, the
    row padded to a multiple of 4 taps."""
    return k * k if planes == 2 else k * -(-k // 4)


def sync_path_bf16(bn: int) -> bool:
    """The bf16 16-channel stems take mma.sync (4 tile rows a warp); wider
    blocks take wgmma (16 x 16 tiles of four m64 tiles)."""
    return bn == 16


def tile_bf16(bn: int) -> tuple[int, int]:
    """(rows, columns) of a bf16 block's output tile."""
    return (32 if sync_path_bf16(bn) else 16), TILE_COLS_BF16


def plan_bf16(c: int, f: int, k: int) -> dict:
    """The bf16 launch's layout in bytes (``conv_gemm_bf16_kernel``): the
    staged plane of IH x IW pixels x 16 bytes, a chunk's packed B, a ring
    slot, the slots held, the shared memory (conv2's, the pool modes', at
    least its output tiles: bn channels of the skip tile, ``skip_stride``
    elements apart, then of the pool tile, ``pool_stride`` apart) and the
    blocks an SM, and the A descriptor's lead (one plane, or two pixels on:
    32 bytes) and stride (one staged row)."""
    bn, cc, kc_pad = conv_plan(c, f, k, torch.bfloat16)
    planes = 2 if cc == 16 else 1
    th, tw = tile_bf16(bn)
    ih, iw = th + k - 1, tw + k - 1
    plane = ih * iw * 16
    w_bytes = kc_pad * bn * 2
    slot = w_bytes + planes * plane
    chunks = -(-c // cc)
    stages = min(chunks, RING_BF16)
    smem = stages * slot
    skip_stride, pool_stride = th * tw + 8, th * tw // 4 + 8
    return {"bn": bn, "cc": cc, "planes": planes, "ksteps": kc_pad // 16, "kc_pad": kc_pad,
            "tile": (th, tw), "ih": ih, "iw": iw, "plane_bytes": plane, "w_bytes": w_bytes,
            "slot_bytes": slot, "chunks": chunks, "stages": stages, "smem_bytes": smem,
            "pool_smem_bytes": max(smem, bn * (skip_stride + pool_stride) * 2),
            "skip_stride": skip_stride, "pool_stride": pool_stride,
            "blocks_per_sm": BLOCKS_PER_SM_BF16, "lead_bytes": plane if planes == 2 else 32,
            "stride_bytes": iw * 16}


def smem_bytes(c: int, f: int, k: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one launch (``make_plan`` in the kernel, or
    ``plan_bf16``: the larger, conv2's)."""
    if dtype == torch.bfloat16:
        return plan_bf16(c, f, k)["pool_smem_bytes"]
    bn, cc, kc_pad = conv_plan(c, f, k)
    side = TILE + k - 1
    w_bytes = kc_pad * bn * 8
    in_bytes = cc * channel_stride(k) * 4
    zero_bytes = TILE * side * 4 if cc * k * k < kc_pad else 0
    stage = w_bytes + ((in_bytes + zero_bytes + 15) & ~15)
    return min(c // cc, STAGES) * stage + 4 * kc_pad


def supported(c: int, f: int, k: int, dtype=torch.float32) -> str | None:
    """Why the kernel cannot take a conv of these widths, or None."""
    if not (f in (16, 32) or f % 64 == 0):
        return f"output channels {f} are not 16, 32 or a multiple of 64"
    if dtype == torch.bfloat16 and c % 16 != 0 and c > 16:
        return f"{c} input channels are neither at most 16 nor a multiple of 16"
    need = smem_bytes(c, f, k, dtype)
    if need > SMEM_LIMIT:
        return f"{c} input channels at k={k} need {need} B of shared memory"
    return None


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero:
    ``cvt.rna.tf32.f32`` on the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def weight_rows(w: torch.Tensor, cc: int, kc_pad: int) -> torch.Tensor:
    """f32 OIHW weights -> the GEMM's B [chunks * kc_pad, F] in (c, kh, kw)
    order: row (j, kk) is input channel j*cc + kk // k^2, tap kk % k^2 (kh, kw)
    of chunk j; rows kk >= cc*k^2 are zero."""
    f, c, k, _ = w.shape
    b = w.reshape(f, c // cc, cc * k * k)
    b = torch.nn.functional.pad(b, (0, kc_pad - cc * k * k))
    return b.permute(1, 2, 0).reshape(-1, f)


def weight_rows_bf16(w: torch.Tensor, cc: int) -> torch.Tensor:
    """bf16 OIHW weights -> the GEMM's B [chunks * kc_pad, F] in (kh, kw, c)
    order, 16 rows a k-step.  Two planes (cc = 16): k-step s is tap s,
    channels j*cc + 0..15 of chunk j.  One plane (cc = 4): k-step s is kernel
    row s // p, taps kw 4 (s % p) .. 4 (s % p) + 3 (p = ceil(k / 4)), 4
    channels each, so that a half (8 rows) is the two taps a pixel-pair row
    feeds.  Channels >= C and taps kw >= k are zero rows."""
    f, c, k, _ = w.shape
    chunks = -(-c // cc)
    b = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, chunks * cc - c)).reshape(f, chunks, cc, k, k)
    if cc == 4:
        b = torch.nn.functional.pad(b, (0, -k % 4))  # kernel rows of 4 k taps
    return b.permute(1, 3, 4, 2, 0).reshape(-1, f)


def weight_planes(w: torch.Tensor, cc: int, kc_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 OIHW weights -> B's TF32 hi and lo planes [chunks * kc_pad, F]."""
    return split_tf32(weight_rows(w, cc, kc_pad))


def _cores(planes, kc_pad: int, bn: int) -> torch.Tensor:
    """B planes [chunks * kc_pad, F] (all of one dtype) -> wgmma's K-major
    core matrices of 16 bytes a row, ``ck`` = 16 bytes of k (4 f32, 8 bf16):
    [F/bn, chunks, kc_pad / (2 ck), plane, bn/8 (ng), 2 (kc), 8 (n % 8), ck (k % ck)]."""
    rows, f = planes[0].shape
    ck = 16 // planes[0].element_size()
    # [plane, chunk, ks, kc, k % ck, nblk, ng, n % 8]: row 2ck*ks + ck*kc + k % ck,
    # column bn*nblk + 8*ng + n % 8
    p = torch.stack(list(planes)).reshape(len(planes), rows // kc_pad, kc_pad // (2 * ck), 2, ck,
                                          f // bn, bn // 8, 8)
    return p.permute(5, 1, 2, 0, 6, 3, 7, 4).contiguous()


def core_matrices(hi: torch.Tensor, lo: torch.Tensor, kc_pad: int, bn: int) -> torch.Tensor:
    """TF32 B planes [chunks * kc_pad, F] -> wgmma's K-major core matrices:
    [F/bn, chunks, kc_pad/8, plane (hi, lo), bn/8 (ng), 2 (kc), 8 (n % 8), 4 (k % 4)]."""
    return _cores((hi, lo), kc_pad, bn)


def core_matrices_bf16(b: torch.Tensor, kc_pad: int, bn: int) -> torch.Tensor:
    """bf16 B [chunks * kc_pad, F] -> wgmma's K-major core matrices:
    [F/bn, chunks, kc_pad/16, 1, bn/8 (ng), 2 (kc), 8 (n % 8), 8 (k % 8)]."""
    return _cores((b,), kc_pad, bn)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW weights -> the kernel's packed B: for f32 the ``core_matrices`` of
    the hi/lo ``weight_planes``, for bf16 those of ``weight_rows_bf16``."""
    f, c, k, _ = w.shape
    bn, cc, kc_pad = conv_plan(c, f, k, w.dtype)
    if w.dtype == torch.bfloat16:
        return core_matrices_bf16(weight_rows_bf16(w, cc), kc_pad, bn)
    return core_matrices(*weight_planes(w, cc, kc_pad), kc_pad, bn)


def cached_on(owner, name: str, sources, make):
    """``make()``, kept on ``owner`` (a tensor or a module) under ``name``
    while the data pointers and version counters of the ``sources`` tensors
    are unchanged.  A kept result is made outside autograd, also under
    inference mode, so that a cache keyed on it in turn works (a net's bf16
    weight cast, then its packing).  It is made afresh and not kept where
    autograd needs a source (the result is then part of the graph) or a
    source is an inference tensor (no version counter)."""
    if any(t.is_inference() for t in sources) or (
            torch.is_grad_enabled() and any(t.requires_grad for t in sources)):
        return make()
    key = tuple((t.data_ptr(), t._version) for t in sources)
    cache = owner.__dict__.setdefault("_cached", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            hit = (key, make())
        cache[name] = hit
    return hit[1]


def packed_weights(w: torch.Tensor) -> torch.Tensor:
    """``pack_weights(w)``, cached on ``w`` (``cached_on``), so a net's weights
    are split or laid out once.  A bf16 ``w`` is a tensor of its own (the nets
    keep their bf16 casts: ``models.layers.cast_param``), so each dtype keeps
    its own packing."""
    return cached_on(w, "conv_gemm_packed", (w,), lambda: pack_weights(w))


def mid_like(x: torch.Tensor, f: int) -> torch.Tensor:
    """An empty conv1 activation of ``f`` channels for the stage input ``x``
    [B, C, H, W]: NCHW in f32, channel-blocked [B, F/8, H, W, 8] in bf16."""
    bsz, _, h, wd = x.shape
    shape = (bsz, f // 8, h, wd, 8) if x.dtype == torch.bfloat16 else (bsz, f, h, wd)
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def conv_gemm(x, w, b, out, pooled, mode: int) -> None:
    """Launch one conv of a stage into ``out`` (and ``pooled`` for the pooling
    modes); the caller has checked shapes, types, devices and ``supported``.
    ``x`` is NCHW, or a channel-blocked bf16 ``mid_like`` (5-D)."""
    if x.dim() == 5:
        bsz, c8, h, wd, _ = x.shape
        c = 8 * c8
    else:
        bsz, c, h, wd = x.shape
    f, _, k, _ = w.shape
    bn, cc, kc_pad = conv_plan(c, f, k, x.dtype)
    wpk = packed_weights(w)
    _build.call(
        ENTRY[x.dtype], k, mode, ptr(x), ptr(wpk), ptr(b), ptr(out),
        ptr(pooled) if pooled is not None else None, bsz, c, f, h, wd, bn, cc, kc_pad,
        stream(x.device),
    )
