"""The shared launch of K2 and K4: one SAME conv as an implicit GEMM on the
tensor cores (``csrc/conv2_pool.cu``), in 3xTF32 for f32 tensors and in one
bf16 product for bf16 tensors, and the weight packing it reads.

The kernel's GEMM has M = the output pixels of a TILE x TILE tile, N = ``bn``
output channels per block, K = C*k*k in (c, kh, kw) order, walked in chunks of
``cc`` input channels.  A chunk's K is zero-padded to ``kc_pad``, a multiple of
the MMA's k-step: 8 in TF32, 16 in bf16 (``K_STEP``).  A layer whose C is a
multiple of the chunk (8 channels in f32, 16 in bf16) needs no padding; one
with C = 3 or 9 is one padded chunk (bf16: K = 147 -> 160, 441 -> 448).

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

TILE = 16  # output tile side (TH = TW in csrc/conv2_pool.cu)
WARPS = 8  # 2 warpgroups; a warp: 2 tile rows x all bn channels
STAGES = 3
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use (common.cuh)

# k of one MMA step, channels of a full chunk, and the C entry point, per dtype
K_STEP = {torch.float32: 8, torch.bfloat16: 16}
CHUNK = {torch.float32: 8, torch.bfloat16: 16}
ENTRY = {torch.float32: "shdr_conv_gemm_f32", torch.bfloat16: "shdr_conv_gemm_bf16"}
# bytes of packed B per weight element: hi + lo TF32 planes, or one bf16
W_BYTES = {torch.float32: 8, torch.bfloat16: 2}

# epilogues (csrc/conv2_pool.cu Mode)
LEAKY_STORE, LEAKY_AVG_POOL, RELU_STORE, RELU_MAX_POOL = range(4)


def conv_plan(c: int, f: int, k: int, dtype=torch.float32) -> tuple[int, int, int]:
    """(bn, cc, kc_pad): output channels per block, input channels per chunk,
    and the chunk's K padded to a multiple of the k-step."""
    bn = f if f in (16, 32) else 64
    cc = CHUNK[dtype] if c % CHUNK[dtype] == 0 else c
    step = K_STEP[dtype]
    kc_pad = -(-cc * k * k // step) * step
    return bn, cc, kc_pad


def channel_stride(k: int, dtype=torch.float32) -> int:
    """Elements between two channels of the staged input tile (bank-spread
    pad).  f32: side^2 + k + 7 floats.  bf16: side^2 rounded up to 48 mod 64
    elements; two bf16 share a 4-byte bank word, and that residue keeps every
    A-fragment load of the main path's layers on distinct words a bank
    (``tests/test_torch_bf16.py`` checks each layer)."""
    side = TILE + k - 1
    if dtype == torch.bfloat16:
        return side * side + (112 - side * side % 64) % 64
    return side * side + k + 7


def smem_bytes(c: int, f: int, k: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one launch (``make_plan`` in the kernel)."""
    bn, cc, kc_pad = conv_plan(c, f, k, dtype)
    elem = 4 if dtype == torch.float32 else 2
    side = TILE + k - 1
    w_bytes = kc_pad * bn * W_BYTES[dtype]
    in_bytes = cc * channel_stride(k, dtype) * elem
    zero_bytes = TILE * side * elem if cc * k * k < kc_pad else 0
    stage = w_bytes + ((in_bytes + zero_bytes + 15) & ~15)
    return min(c // cc, STAGES) * stage + 4 * kc_pad


def supported(c: int, f: int, k: int, dtype=torch.float32) -> str | None:
    """Why the kernel cannot take a conv of these widths, or None."""
    if not (f in (16, 32) or f % 64 == 0):
        return f"output channels {f} are not 16, 32 or a multiple of 64"
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
    """OIHW weights -> the GEMM's B [chunks * kc_pad, F], in ``w``'s dtype:
    row (j, kk) is input channel j*cc + kk // k^2, tap kk % k^2 (kh, kw) of
    chunk j; rows kk >= cc*k^2 are zero."""
    f, c, k, _ = w.shape
    b = w.reshape(f, c // cc, cc * k * k)
    b = torch.nn.functional.pad(b, (0, kc_pad - cc * k * k))
    return b.permute(1, 2, 0).reshape(-1, f)


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
    the hi/lo ``weight_planes``, for bf16 those of the bf16 ``weight_rows``."""
    f, c, k, _ = w.shape
    bn, cc, kc_pad = conv_plan(c, f, k, w.dtype)
    if w.dtype == torch.bfloat16:
        return core_matrices_bf16(weight_rows(w, cc, kc_pad), kc_pad, bn)
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


def conv_gemm(x, w, b, out, pooled, mode: int) -> None:
    """Launch one conv of a stage into ``out`` (and ``pooled`` for the pooling
    modes); the caller has checked shapes, types, devices and ``supported``."""
    bsz, c, h, wd = x.shape
    f, _, k, _ = w.shape
    bn, cc, kc_pad = conv_plan(c, f, k, x.dtype)
    wpk = packed_weights(w)
    _build.call(
        ENTRY[x.dtype], k, mode, ptr(x), ptr(wpk), ptr(b), ptr(out),
        ptr(pooled) if pooled is not None else None, bsz, c, f, h, wd, bn, cc, kc_pad,
        stream(x.device),
    )
