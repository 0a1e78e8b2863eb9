"""K3: Linearization-Net front end — the 93-channel feature stack and the
BN-folded 7x7/2 stem in one pass.

Replaces ``singlehdr_tpu/ops/pallas/lin_stem_pallas.py`` (``lin_feature_stem``),
which kept the 93-channel stack out of HBM.  ``csrc/lin_stem.cu`` builds
each block's features in shared memory, a chunk of channels at a time, and
runs the stem over them as an implicit GEMM on the tensor cores (3xTF32 for
f32, one bf16 product for bf16), so the stack never reaches device memory
either.  The kernel applies the border
rules itself — Sobel REFLECT padding, the stack zero-padded as features,
asymmetric SAME padding at stride 2 — so the TPU wrapper's border-ring
recompute has no counterpart here.  Bound by the stem's multiply-adds
(49 * 93 * 64 an output pixel).

The GEMM of a block: M = a TILE x TILE output tile, N = 64, K = 96 * 49 in
12 chunks of 8 channels (93 padded to 96 with zero weights), each chunk 49
k-steps of one tap (ky, kx) x 8 channels.  The chunk's features are split
once into TF32 hi/lo planes; in a plane, channel ``cl``, receptive-field row
``ry`` and column ``rx`` sit at ``cl * CHANNEL_STRIDE + ry * ROW + (rx % 2) *
PARITY_WIDTH + rx // 2``.  ``pack_stem_weights`` lays out B to match.

bf16 (x, the folded kernel and the output bf16, the bias f32): chunks of 16
channels (6), each k-step one tap x 16 channels; the features are built in
f32 from the bf16 image and rounded once.  The block is warp-specialised
(``plan_bf16``): two producer warpgroups build chunk j + 1 into one of two
feature buffers while two consumer warpgroups run chunk j's 49 k-steps on
``wgmma`` with both operands read from shared memory by descriptor, and one
thread copies B (``conv_gemm``'s bf16 core matrices, one kernel row a ring
slot) with ``cp.async.bulk``; mbarriers hand buffers and slots over.  One
block an SM walks the tiles, so the producers start the next tile while the
consumers finish the last.  A buffer is channel-inner: 16-byte row ``e`` of
8-channel group ``h`` (byte ``h * group_bytes + 16 * e``) holds channels
``8h .. 8h + 7`` of receptive row ``e // ROW`` at column-parity entry
``e % ROW`` (column ``2 e'`` for ``e' < PARITY_WIDTH``, else
``2 (e' - PARITY_WIDTH) + 1``), so the 8 output columns of a tap are one
8 x 16-byte core matrix.  With pixels as N the 64 output channels are the
GEMM's M (the packed weights are the A operand) and a consumer warpgroup's
16 output rows x 8 columns its N = 128.  The plain version rounds where the
kernel rounds: each feature, then the output.

Layout: x [B, 3, H, W]; kernel OIHW [64, 93, 7, 7]; output NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from singlehdr_tpu_torch.ops.cuda import _build
from singlehdr_tpu_torch.ops.cuda._check import (
    conv_dtype,
    count_launch,
    cuda_tensor,
    no_grad_needed,
    ptr,
    require,
    stream,
)
from singlehdr_tpu_torch.ops.cuda.conv_gemm import (
    BLOCK_RESERVED,
    SM_SMEM,
    SMEM_LIMIT,
    cached_on,
    core_matrices,
    core_matrices_bf16,
    split_tf32,
)
from singlehdr_tpu_torch.ops.histogram import N_FEATURES, linearization_features
from singlehdr_tpu_torch.ops.resize import same_pads

OUT_F = 64
KSIZE = 7
TILE = 16                           # output tile side (csrc/lin_stem.cu TO)
FIELD = 2 * TILE + KSIZE - 2        # receptive field side, 37
PARITY_WIDTH = (FIELD + 1) // 2     # 19
ROW = 2 * PARITY_WIDTH              # 38
CHANNEL_STRIDE = 1416               # >= FIELD * ROW, = 8 mod 32: bank-spread
CHUNK = 8                           # channels a chunk (f32)
CHUNKS = -(-N_FEATURES // CHUNK)    # 12
C_PAD = CHUNKS * CHUNK              # 96
CHUNK_BF16 = 16                     # channels a chunk (bf16): one k-step of 16
CHUNKS_BF16 = C_PAD // CHUNK_BF16   # 6
SLICE_KSTEPS = 7                    # k-steps a slot of the B ring (one kernel row)
RING_SLOTS = 4
WARPS = 8
ENTRY = {torch.float32: "shdr_lin_stem_f32", torch.bfloat16: "shdr_lin_stem_bf16"}


# bf16 (csrc/lin_stem.cu, the bf16 section)
RING_SLOTS_BF16 = 4          # B ring slots, one kernel row (7 k-steps, 14 KB) each
CONSUMER_WARPS = 8           # two warpgroups run the MMAs
PRODUCER_WARPS = 8           # two warpgroups build the features


def smem_bytes(dtype=torch.float32) -> int:
    """Dynamic shared memory of a launch.  f32: B ring, hi and lo feature
    planes of 8 channels, image, channel table; bf16: ``plan_bf16``."""
    if dtype == torch.bfloat16:
        return plan_bf16()["smem_bytes"]
    ring_bytes = RING_SLOTS * SLICE_KSTEPS * 2 * OUT_F * CHUNK * 4
    return ring_bytes + 4 * (2 * CHUNK * CHANNEL_STRIDE + 3 * (FIELD + 2) ** 2 + 3 * C_PAD)


def plan_bf16(tile_rows: int = TILE) -> dict:
    """The bf16 launch's layout in bytes (``lin_stem_bf16_kernel``), for an
    output tile of ``tile_rows`` x 16: the B ring (``slice_bytes`` a slot),
    two feature buffers of two 8-channel groups (``group_bytes`` apart: the
    descriptors' lead) of ``field_rows`` x ROW 16-byte rows, the f32 image,
    the mbarriers; the descriptors' stride (one output row, two receptive
    rows); the threads (consumers, producers, one loader warp), the blocks
    an SM and whether it fits (at 32 rows the two buffers beside the ring do
    not)."""
    field_rows = 2 * tile_rows + KSIZE - 2
    group_bytes = field_rows * ROW * 16
    feat_bytes = 2 * group_bytes
    slice_bytes = SLICE_KSTEPS * OUT_F * CHUNK_BF16 * 2
    feat_offset = RING_SLOTS_BF16 * slice_bytes
    img_offset = feat_offset + 2 * feat_bytes
    bar_offset = -(-(img_offset + 3 * (field_rows + 2) * (FIELD + 2) * 4) // 8) * 8
    smem = bar_offset + 8 * (2 * RING_SLOTS_BF16 + 4)
    return {"tile": (tile_rows, TILE), "field_rows": field_rows, "ring_slots": RING_SLOTS_BF16,
            "slice_bytes": slice_bytes, "slices": CHUNKS_BF16 * KSIZE, "group_bytes": group_bytes,
            "feat_bytes": feat_bytes, "feat_offset": feat_offset, "img_offset": img_offset,
            "bar_offset": bar_offset, "smem_bytes": smem, "lead_bytes": group_bytes,
            "stride_bytes": 2 * ROW * 16, "kstep_bytes": OUT_F * CHUNK_BF16 * 2,
            "consumer_warps": CONSUMER_WARPS, "producer_warps": PRODUCER_WARPS,
            "threads": 32 * (CONSUMER_WARPS + PRODUCER_WARPS + 1),
            "fits": smem <= SMEM_LIMIT, "blocks_per_sm": SM_SMEM // (smem + BLOCK_RESERVED)}


def lin_feature_stem_plain(x, kernel7, bias):
    """Plain version: ``relu(conv7x7/2_SAME(linearization_features(x)) + bias)``.
    For bf16 x and kernel7 (f32 bias) it computes what the bf16 kernel
    computes: the features in f32 from the bf16 image, each rounded to bf16
    once, the conv in f32 on those values (exact products), and the output
    rounded to bf16.  On the card it needs TF32 off."""
    feats = linearization_features(x)
    pt, pb = same_pads(x.shape[2], 7, 2)
    pl, pr = same_pads(x.shape[3], 7, 2)
    feats = F.pad(feats, (pl, pr, pt, pb))
    if x.dtype == torch.bfloat16:
        y = F.conv2d(feats.float(), kernel7.float(), bias, stride=2)
        return F.relu(y).to(x.dtype)
    return F.relu(F.conv2d(feats, kernel7, bias, stride=2))


def stem_weight_planes(kernel7: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[64, 93, 7, 7] -> B's hi and lo planes [CHUNKS * 49 * 8, 64]: row
    (j * 49 + ky * 7 + kx) * 8 + cl is channel j * 8 + cl at tap (ky, kx);
    channels 93..95 are zero."""
    w = F.pad(kernel7, (0, 0, 0, 0, 0, C_PAD - kernel7.shape[1]))
    b = w.reshape(OUT_F, CHUNKS, CHUNK, KSIZE * KSIZE).permute(1, 3, 2, 0)
    return split_tf32(b.reshape(-1, OUT_F))


def stem_weight_rows_bf16(kernel7: torch.Tensor) -> torch.Tensor:
    """bf16 [64, 93, 7, 7] -> B [CHUNKS_BF16 * 49 * 16, 64]: row
    (j * 49 + ky * 7 + kx) * 16 + cl is channel j * 16 + cl at tap (ky, kx);
    channels 93..95 are zero."""
    w = F.pad(kernel7, (0, 0, 0, 0, 0, C_PAD - kernel7.shape[1]))
    b = w.reshape(OUT_F, CHUNKS_BF16, CHUNK_BF16, KSIZE * KSIZE).permute(1, 3, 2, 0)
    return b.reshape(-1, OUT_F)


def pack_stem_weights(kernel7: torch.Tensor) -> torch.Tensor:
    """The kernel's packed B in conv_gemm's core-matrix layout, a chunk of 49
    k-steps: f32 [1, CHUNKS, 49, plane (hi, lo), 8 (ng), 2 (kc), 8, 4] (392
    deep); bf16 [1, CHUNKS_BF16, 49, 1, 8 (ng), 2 (kc), 8, 8] (784 deep)."""
    if kernel7.dtype == torch.bfloat16:
        return core_matrices_bf16(stem_weight_rows_bf16(kernel7), KSIZE * KSIZE * CHUNK_BF16,
                                  OUT_F)
    hi, lo = stem_weight_planes(kernel7)
    return core_matrices(hi, lo, KSIZE * KSIZE * CHUNK, OUT_F)


def packed_stem_weights(kernel7: torch.Tensor) -> torch.Tensor:
    """``pack_stem_weights(kernel7)``, kept on ``kernel7`` while its data and
    version are unchanged.  The nets hand K3 the same folded tensor while the
    stem's weight and bias and the four BN tensors are unchanged
    (``models.linearization.CrfFeatureNet.folded_stem``), so the stem is
    packed once."""
    return cached_on(kernel7, "lin_stem_packed", (kernel7,), lambda: pack_stem_weights(kernel7))


def check_stem(x, kernel7, bias) -> torch.dtype:
    """K3's argument checks; returns the compute dtype.  x and kernel7 in one
    dtype (f32 or bf16), the bias f32."""
    dtype = conv_dtype("lin_feature_stem", x)
    cuda_tensor("lin_feature_stem: x", x, x.device, 4, dtype)
    cuda_tensor("lin_feature_stem: kernel7", kernel7, x.device, 4, dtype)
    cuda_tensor("lin_feature_stem: bias", bias, x.device, 1, torch.float32)
    B, C, H, W = x.shape
    require(C == 3, f"lin_feature_stem: {C} input channels, expected 3")
    require(B > 0 and H > 0 and W > 0, f"lin_feature_stem: empty input {tuple(x.shape)}")
    require(tuple(kernel7.shape) == (OUT_F, N_FEATURES, 7, 7),
            f"lin_feature_stem: kernel {tuple(kernel7.shape)} != {(OUT_F, N_FEATURES, 7, 7)}")
    require(tuple(bias.shape) == (OUT_F,), f"lin_feature_stem: bias must be [{OUT_F}]")
    no_grad_needed("lin_feature_stem", x, kernel7, bias)
    return dtype


def lin_feature_stem(x, kernel7, bias):
    """K3 wrapper: [B, 3, H, W] -> [B, 64, ceil(H/2), ceil(W/2)].

    ``kernel7`` [64, 93, 7, 7] / ``bias`` [64] are the BN-folded eval stem;
    x and kernel7 f32 or bf16, bias f32; the output in x's dtype.  Plain
    version on the CPU, the kernel on the GPU.
    """
    if x.device.type == "cpu":
        return lin_feature_stem_plain(x, kernel7, bias)
    require(x.device.type == "cuda", f"lin_feature_stem: no kernel for device {x.device}")
    dtype = check_stem(x, kernel7, bias)
    B, C, H, W = x.shape
    ho, wo = -(-H // 2), -(-W // 2)
    pad_t, _ = same_pads(H, 7, 2)
    pad_l, _ = same_pads(W, 7, 2)
    out = torch.empty((B, OUT_F, ho, wo), dtype=x.dtype, device=x.device)
    wpk = packed_stem_weights(kernel7)
    with torch.cuda.device(x.device):
        _build.call(
            ENTRY[dtype], ptr(x), ptr(wpk), ptr(bias), ptr(out),
            B, H, W, ho, wo, pad_t, pad_l, stream(x.device),
        )
    count_launch(lin_feature_stem, dtype)
    return out


lin_feature_stem.launches_by_dtype = {}
