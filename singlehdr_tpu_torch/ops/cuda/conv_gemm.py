"""The shared launch of K2 and K4: one SAME conv as an implicit GEMM on the
tensor cores in 3xTF32 (``csrc/conv2_pool.cu``), and the weight packing it
reads.

The kernel's GEMM has M = the output pixels of a TILE x TILE tile, N = ``bn``
output channels per block, K = C*k*k in (c, kh, kw) order, walked in chunks of
``cc`` input channels.  A chunk's K is zero-padded to ``kc_pad``, a multiple of
8 (the MMA's k), so a layer with C a multiple of 8 needs no padding and one
with C = 3 or 9 is one padded chunk.  Each weight is split once here into
hi = rna_tf32(w) and lo = rna_tf32(w - hi), and laid out as ``wgmma`` reads
its B operand from shared memory: per (N block, chunk, k-step of 8, plane hi
or lo), K-major core matrices of 8 n x 4 k, the core (n8 group ng, k half kc)
at float offset 32 * (2 * ng + kc), n at 4 * (n % 8), k at k % 4.
"""

from __future__ import annotations

import torch

from singlehdr_tpu_torch.ops.cuda import _build
from singlehdr_tpu_torch.ops.cuda._check import ptr, stream

TILE = 16  # output tile side (TH = TW in csrc/conv2_pool.cu)
WARPS = 8  # 2 warpgroups; a warp: 2 tile rows x all bn channels
STAGES = 3
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may use (common.cuh)

# epilogues (csrc/conv2_pool.cu Mode)
LEAKY_STORE, LEAKY_AVG_POOL, RELU_STORE, RELU_MAX_POOL = range(4)


def conv_plan(c: int, f: int, k: int) -> tuple[int, int, int]:
    """(bn, cc, kc_pad): output channels per block, input channels per chunk,
    and the chunk's K padded to a multiple of 8."""
    bn = f if f in (16, 32) else 64
    cc = 8 if c % 8 == 0 else c
    kc_pad = -(-cc * k * k // 8) * 8
    return bn, cc, kc_pad


def channel_stride(k: int) -> int:
    """Floats between two channels of the staged input tile (bank-spread pad)."""
    return (TILE + k - 1) ** 2 + k + 7


def smem_bytes(c: int, f: int, k: int) -> int:
    """Dynamic shared memory of one launch (``make_plan`` in the kernel)."""
    bn, cc, kc_pad = conv_plan(c, f, k)
    side = TILE + k - 1
    w_floats = kc_pad * bn * 2
    in_floats = cc * channel_stride(k)
    zero_floats = TILE * side if cc * k * k < kc_pad else 0
    stage = w_floats + ((in_floats + zero_floats + 3) & ~3)
    return 4 * (min(c // cc, STAGES) * stage + kc_pad)


def supported(c: int, f: int, k: int) -> str | None:
    """Why the kernel cannot take a conv of these widths, or None."""
    if not (f in (16, 32) or f % 64 == 0):
        return f"output channels {f} are not 16, 32 or a multiple of 64"
    if smem_bytes(c, f, k) > SMEM_LIMIT:
        return f"{c} input channels at k={k} need {smem_bytes(c, f, k)} B of shared memory"
    return None


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero:
    ``cvt.rna.tf32.f32`` on the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def weight_planes(w: torch.Tensor, cc: int, kc_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """OIHW weights -> the GEMM's B as hi and lo planes [chunks * kc_pad, F]:
    row (j, kk) is input channel j*cc + kk // k^2, tap kk % k^2 (kh, kw) of
    chunk j; rows kk >= cc*k^2 are zero."""
    f, c, k, _ = w.shape
    b = w.reshape(f, c // cc, cc * k * k)
    b = torch.nn.functional.pad(b, (0, kc_pad - cc * k * k))
    b = b.permute(1, 2, 0).reshape(-1, f)
    return split_tf32(b)


def core_matrices(hi: torch.Tensor, lo: torch.Tensor, kc_pad: int, bn: int) -> torch.Tensor:
    """B planes [chunks * kc_pad, F] -> wgmma's K-major core matrices:
    [F/bn, chunks, kc_pad/8, plane (hi, lo), bn/8 (ng), 2 (kc), 8 (n % 8), 4 (k % 4)]."""
    rows, f = hi.shape
    # [plane, chunk, ks, kc, k % 4, nblk, ng, n % 8]: row 8*ks + 4*kc + k % 4, column bn*nblk + 8*ng + n % 8
    p = torch.stack([hi, lo]).reshape(2, rows // kc_pad, kc_pad // 8, 2, 4, f // bn, bn // 8, 8)
    return p.permute(5, 1, 2, 0, 6, 3, 7, 4).contiguous()


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW f32 weights -> the kernel's packed B (``core_matrices`` of the
    ``weight_planes``)."""
    f, c, k, _ = w.shape
    bn, cc, kc_pad = conv_plan(c, f, k)
    hi, lo = weight_planes(w, cc, kc_pad)
    return core_matrices(hi, lo, kc_pad, bn)


def packed_weights(w: torch.Tensor) -> torch.Tensor:
    """``pack_weights(w)``, kept on ``w`` while its data pointer and version
    counter are unchanged, so a net's weights are split once."""
    if w.is_inference():  # no version counter: pack every call
        return pack_weights(w)
    key = (w.data_ptr(), w._version)
    hit = getattr(w, "_conv_gemm_packed", None)
    if hit is None or hit[0] != key:
        hit = (key, pack_weights(w))
        w._conv_gemm_packed = hit
    return hit[1]


def conv_gemm(x, w, b, out, pooled, mode: int) -> None:
    """Launch one conv of a stage into ``out`` (and ``pooled`` for the pooling
    modes); the caller has checked shapes, types, devices and ``supported``."""
    bsz, c, h, wd = x.shape
    f, _, k, _ = w.shape
    bn, cc, kc_pad = conv_plan(c, f, k)
    wpk = packed_weights(w)
    _build.call(
        "shdr_conv_gemm_f32", k, mode, ptr(x), ptr(wpk), ptr(b), ptr(out),
        ptr(pooled) if pooled is not None else None, bsz, c, f, h, wd, bn, cc, kc_pad,
        stream(x.device),
    )
