"""Time K3's bf16 kernel by part and against the alternatives to its design
choices, on one card, in turns: tree, variants..., tree.

  python3 -m singlehdr_tpu_torch.tools.stem_variants [--variants a,b] [--out FILE]

A variant is the tree's ``csrc/lin_stem.cu`` with a few text edits
(``SOURCE_EDITS``), built with ``_build.NVCC_FLAGS`` into its own library
under ``build/kernels/variants/`` (``conv_variants.build_variants``).  Each
runs the bf16 K3 cases of ``chip_smoke.kernel_cases`` (b4 at 576^2, and the
odd [1, 3, 37, 53]), timed with ``chip_smoke.device_ms``.

Design choices, each first held to the plain version within chip_smoke's
bf16 bound (``CHOICES``):

- ``pixels_as_m``: the GEMM with the output pixels as M (two m64n64k16 a tap
  and consumer warpgroup: A an 8 x 8 pixel tile of features, B the weights)
  instead of the output channels as M and 16 rows x 8 columns of pixels as N
  (one m64n128k16);
- ``one_producer_warpgroup``: one warpgroup builds the features, not two;
- ``one_tile_a_block``: a block a tile (as many blocks as tiles) instead of
  one block an SM walking the tiles, whose producers stage the next tile's
  image and build its first chunk while the consumers finish the last;
- ``cp_async_ring``: the loader warp's 32 lanes copy B with 16-byte
  cp.async, each lane's copies arriving on the slot's barrier when they land,
  instead of one thread's cp.async.bulk;
- ``ring_2``, ``ring_8``: 2 or 8 B ring slots instead of 4.

Ablations, which compute something else and are timed only (``ABLATIONS``):
``no_mmas`` (the consumers issue no wgmma), ``no_feature_build`` (the
producers write no features, only hand the buffers over), ``no_b_stream``
(the loader copies no B, only marks the slots full), ``no_stores`` (the
epilogue stores nothing).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

TREE = "tree"
SOURCE = "lin_stem.cu"

_MMA_N = '''          const uint32_t f = fst + (ky * ROW + col + 8 * cw) * 16;
          wgmma_bf16_ss<2 * OUT_F>(acc, wd, smem_desc(f, kGroupBytes, kOutRowBytes));'''
_MMA_M = '''#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const uint32_t f = fst + ((16 * cw + ky) * ROW + col + 8 * mt) * 16;
            wgmma_bf16_ss<OUT_F>(acc[mt], smem_desc(f, kGroupBytes, kOutRowBytes), wd);
          }'''
_STORES_N = '''      // two neighbouring columns a store, 4 bytes where the rows are even
      uint16_t* ob = out + static_cast<long long>(b) * OUT_F * HO * WO;
      const int ox = ox0 + 8 * cw + 2 * t;
      const bool pairs = (WO & 1) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 16 * wq + g + 8 * h;
        const float bv = __ldg(bias + n);
        uint16_t* on = ob + static_cast<long long>(n) * HO * WO;
#pragma unroll
        for (int r = 0; r < TO; ++r) {
          const int oy = oy0 + r;
          if (oy < HO && ox < WO) {
            const uint16_t v0 = bf16_bits(fmaxf(acc[4 * r + 2 * h] + bv, 0.0f));
            const uint16_t v1 = bf16_bits(fmaxf(acc[4 * r + 2 * h + 1] + bv, 0.0f));
            uint16_t* dst = on + static_cast<long long>(oy) * WO + ox;
            if (pairs) {
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
            } else {
              dst[0] = v0;
              if (ox + 1 < WO) dst[1] = v1;
            }
          }
        }
      }
'''
# pixels as M: acc[mt][4 nt + i] is output row 8 cw + 2 wq + (i >> 1), column
# 8 mt + g, channel 8 nt + 2t + (i & 1); one 2-byte store a value
_STORES_M = '''      uint16_t* ob = out + static_cast<long long>(b) * OUT_F * HO * WO;
#pragma unroll
      for (int nt = 0; nt < OUT_F / 8; ++nt) {
        const float b0 = __ldg(bias + nt * 8 + 2 * t), b1 = __ldg(bias + nt * 8 + 2 * t + 1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int oy = oy0 + 8 * cw + 2 * wq + (i >> 1), ox = ox0 + 8 * mt + g;
            const int n = nt * 8 + 2 * t + (i & 1);
            if (oy < HO && ox < WO) {
              ob[(static_cast<long long>(n) * HO + oy) * WO + ox] =
                  bf16_bits(fmaxf(acc[mt][4 * nt + i] + (i & 1 ? b1 : b0), 0.0f));
            }
          }
        }
      }
'''
_BULK_COPY = '''        mbar_arrive_expect_tx(full_b + 8 * slot, kSliceBytesBf16);
        bulk_copy(smem0 + slot * kSliceBytesBf16, src, kSliceBytesBf16, full_b + 8 * slot);'''
_CP_ASYNC_COPY = '''        for (int i = lane; i < kSliceBytesBf16 / 16; i += 32) {
          cp_async16(smem_bf16 + slot * kSliceBytesBf16 + 16 * i, src + i);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(full_b + 8 * slot)
                     : "memory");'''
_FULL_B_WAIT = "        mbar_wait(full_b + 8 * (q % kRingBf16), (q / kRingBf16) & 1);\n"

# name -> list of (old, new) text edits of csrc/lin_stem.cu
CHOICES = {
    "pixels_as_m": [
        ("      float acc[OUT_F] = {};", "      float acc[2][OUT_F / 2] = {};"),
        (_MMA_N, _MMA_M),
        (_STORES_N, _STORES_M),
    ],
    "one_producer_warpgroup": [("constexpr int kProducerWarps = 8;",
                                "constexpr int kProducerWarps = 4;")],
    "one_tile_a_block": [
        ("  const int grid = n_tiles < sms ? static_cast<int>(n_tiles) : sms;  // one block an SM",
         "  const int grid = static_cast<int>(n_tiles);")],
    "cp_async_ring": [
        ("      mbar_init(full_b + 8 * i, 1);", "      mbar_init(full_b + 8 * i, 32);"),
        ("  } else if (lane == 0) {\n    // slice s", "  } else {\n    // slice s"),
        (_BULK_COPY, _CP_ASYNC_COPY),
        # cp.async writes through the generic proxy: fence before wgmma reads
        (_FULL_B_WAIT,
         _FULL_B_WAIT + '        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'),
    ],
    "ring_2": [("constexpr int kRingBf16 = 4;", "constexpr int kRingBf16 = 2;")],
    "ring_8": [("constexpr int kRingBf16 = 4;", "constexpr int kRingBf16 = 8;")],
}
ABLATIONS = {
    "no_mmas": [("          wgmma_bf16_ss<2 * OUT_F>(acc, wd, smem_desc(f, kGroupBytes, kOutRowBytes));",
                 "          (void)wd;\n          (void)f;")],
    "no_feature_build": [("  for (int e = ptid; e < kGroupRows; e += kProducerThreads) {",
                          "  for (int e = ptid; e < 0; e += kProducerThreads) {")],
    "no_b_stream": [(_BULK_COPY, "        (void)src;\n        mbar_arrive(full_b + 8 * slot);")],
    "no_stores": [("          const int oy = oy0 + r;\n          if (oy < HO && ox < WO) {",
                   "          const int oy = oy0 + r;\n          if (oy < 0) {")],
}
SOURCE_EDITS = {**CHOICES, **ABLATIONS}
VARIANTS = tuple(SOURCE_EDITS)


def edited_source(name: str, text: str) -> str:
    for old, new in SOURCE_EDITS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: the edit does not match csrc/{SOURCE} once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def time_cases(cases, cs, checked: bool) -> list:
    """[(label, ms, rel err, equal share)]; a design choice is held to the
    plain version first (an ablation's error is left as None)."""
    from singlehdr_tpu_torch.ops.cuda import lin_stem_cuda

    rows = []
    for _, label, args in cases:
        rel = equal = None
        if checked:
            got = lin_stem_cuda.lin_feature_stem(*args)
            want = lin_stem_cuda.lin_feature_stem_plain(*args)
            rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
            equal = (got == want).float().mean().item()
            if not (rel <= cs.KERNEL_BF16_REL_TOL and equal >= cs.KERNEL_BF16_MIN_EQUAL):
                raise AssertionError(f"{label}: rel {rel:.3e}, {equal:.2%} equal")
        rows.append((label, cs.device_ms(lambda: lin_stem_cuda.lin_feature_stem(*args)), rel, equal))
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default=",".join(VARIANTS),
                   help=f"comma-separated, of {', '.join(VARIANTS)}")
    p.add_argument("--out", help="also write the numbers to this JSON file")
    args = p.parse_args()
    names = [n for n in args.variants.split(",") if n]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        p.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        print("stem_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from singlehdr_tpu_torch.models import build_pipeline
    from singlehdr_tpu_torch.ops.cuda import _build
    from singlehdr_tpu_torch.precision import use_full_f32
    from singlehdr_tpu_torch.tools.conv_variants import build_variants

    use_full_f32()
    t0 = time.perf_counter()
    tree = _build.lib()
    libs = {TREE: tree, **build_variants(names, SOURCE, edited_source)}
    print(f"{cs.card_line()}  built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    pipe = build_pipeline(seed=cs.SEED, device=dev)
    with torch.no_grad():  # not inference tensors: the packing is cached on them
        cases = [c for c in cs.kernel_cases(pipe, dev, torch.bfloat16)
                 if c[0] == "lin_feature_stem"]
    results = []
    with torch.inference_mode():
        for name in [TREE, *names, TREE]:
            _build._lib = libs[name]
            try:
                rows = time_cases(cases, cs, name not in ABLATIONS)
            finally:
                _build._lib = tree
            print(f"== {name}: " + "  ".join(
                f"{label} {ms:.4f} ms" + (f" (rel {rel:.2e}, equal {eq:.2%})" if rel is not None else "")
                for label, ms, rel, eq in rows), flush=True)
            results.append({"variant": name, "cases": [
                {"label": lb, "ms": ms, "rel": r, "equal": e} for lb, ms, r, e in rows]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": cs.card_line(), "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
