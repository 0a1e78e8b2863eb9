"""Time design variants of the bf16 K2/K4 conv kernel against the tree's, each
conv launch by layer, on one card, in turns: tree, variants..., tree.

  python3 -m singlehdr_tpu_torch.tools.conv_variants [--variants a,b] [--out FILE]

A variant is the tree's ``csrc/conv2_pool.cu`` with a few text edits, or the
tree's kernel under another packing plan (``VARIANTS``); the edited source
builds with ``_build.NVCC_FLAGS`` into a library of its own under
``build/kernels/variants/``, beside the tree's other sources compiled once.  Each variant's bf16 K2/K4 cases
(``chip_smoke.kernel_cases``) are first held to the plain versions within
chip_smoke's bf16 bound, then timed with ``chip_smoke.device_ms``: each stage
call and each of its two conv launches alone.  Variants:

- ``wgmma_stems``: the 16-channel stems on wgmma m64n16k16 (A and B read from
  shared memory, 16 x 16 tiles) instead of mma.sync fed by ldmatrix;
- ``register_epilogue``: conv2 writes the skip and the pool from registers,
  2 bytes a store, instead of staging both in shared memory for 16-byte rows;
- ``staging_after_mmas``: conv1 loads a chunk after the chunk before it has
  run, instead of while its MMAs run;
- ``sixteen_channel_rgb``: the 3-channel inputs staged as two planes of 8
  channels (13 of them zero), one tap a k-step, instead of rows of pixel
  pairs x 4 channels, four taps a k-step.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

TREE = "tree"
_WGMMA_N16 = r'''
template <>
__device__ __forceinline__ void wgmma_bf16_ss<16>(float (&d)[8], uint64_t a_desc, uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a_desc), "l"(b_desc));
}
'''

# name -> list of (old, new) text edits of csrc/conv2_pool.cu
SOURCE_EDITS = {
    "wgmma_stems": [
        ("template <int BN>\n__host__ __device__ constexpr bool sync_path() {\n  return BN == 16;\n}",
         "template <int BN>\n__host__ __device__ constexpr bool sync_path() {\n  return false;\n}"
         + _WGMMA_N16),
    ],
    "register_epilogue": [
        ("    if (!(g & 1)) ps[n * PCS + (y / 2) * (TW_ / 2) + xx / 2] = bf16_bits(v);",
         "    const int py = (ty0 + y) / 2, px = (tx0 + xx) / 2;\n"
         "    if (!(g & 1) && py < PH && px < PW) {\n"
         "      pooled[((static_cast<long long>(b) * F + n0 + n) * PH + py) * PW + px] = bf16_bits(v);\n"
         "    }"),
        ("          es[(nt * 8 + 2 * t + (i & 1)) * ECS + row_of(mt, i) * TW_ + col_of(mt, i)] =\n"
         "              bf16_bits(acc[mt][4 * nt + i]);",
         "          const int y = ty0 + row_of(mt, i), xx = tx0 + col_of(mt, i);\n"
         "          if (y < H && xx < W) {\n"
         "            out[(static_cast<long long>(b) * F + n + (i & 1)) * plane + "
         "static_cast<long long>(y) * W + xx] = bf16_bits(acc[mt][4 * nt + i]);\n"
         "          }"),
        ("    copy_rows(es, ECS, TH_, TW_, out + (static_cast<long long>(b) * F + n0) * plane, H, W, ty0,\n"
         "              tx0);\n"
         "    copy_rows(ps, PCS, TH_ / 2, TW_ / 2, pooled + (static_cast<long long>(b) * F + n0) * PH * PW,\n"
         "              PH, PW, ty0 / 2, tx0 / 2);",
         "    (void)copy_rows;"),
    ],
    "staging_after_mmas": [
        ("  constexpr bool kAhead = !kPool && !kSync && U * 8 <= kStageRegs;",
         "  constexpr bool kAhead = false;"),
    ],
}
PLAN_VARIANTS = ("sixteen_channel_rgb",)
VARIANTS = tuple(SOURCE_EDITS) + PLAN_VARIANTS


def edited_source(name: str, text: str) -> str:
    for old, new in SOURCE_EDITS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: the edit does not match csrc/conv2_pool.cu once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(names, source: str = "conv2_pool.cu", edit=edited_source) -> dict:
    """Compile every source variant, all nvcc processes at once: the tree's
    other sources once, and ``source`` with ``edit(name, text)`` applied once
    a variant; link each variant and load it with the tree's C signatures."""
    from singlehdr_tpu_torch.ops.cuda import _build

    nvcc = _build._nvcc()
    rest = _build.BUILD_DIR / "variants" / f"rest_of_{source.split('.')[0]}"
    rest.mkdir(parents=True, exist_ok=True)
    for src in _build.sources():
        (rest / src.name).write_text(src.read_text())

    def compile_(cu, out_dir):
        return subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(rest), "-c", "-o", str(out_dir / f"{cu.stem}.o"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = [compile_(cu, rest) for cu in sorted(rest.glob("*.cu")) if cu.name != source]
    for name in names:
        d = _build.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(edit(name, (_build.CSRC / source).read_text()))
        procs.append(compile_(d / source, d))
    for p in procs:
        msg = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {p.args[-1]}:\n{msg[-3000:]}")
    others = sorted(str(o) for o in rest.glob("*.o") if o.stem != source.split(".")[0])
    libs = {}
    for name in names:
        d = _build.BUILD_DIR / "variants" / name
        so = d / "lib.so"
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                        str(d / f"{source.split('.')[0]}.o"), *others], check=True)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.shdr_error_string.argtypes = (ctypes.c_int,)
        lib.shdr_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def sixteen_channel_plan():
    """``sixteen_channel_rgb``: conv_plan with 16-channel chunks for every C
    (the kernel takes C < 16 as one chunk of two planes).  Returns the undo."""
    from singlehdr_tpu_torch.ops.cuda import conv_gemm

    plan = conv_gemm.conv_plan

    def patched(c, f, k, dtype=torch.float32):
        if dtype != torch.bfloat16:
            return plan(c, f, k, dtype)
        bn = plan(c, f, k, dtype)[0]
        return bn, 16, 16 * conv_gemm.ksteps_bf16(k, 2)

    conv_gemm.conv_plan = patched
    return lambda: setattr(conv_gemm, "conv_plan", plan)


def time_cases(cases, cs) -> list:
    """[(kernel, label, stage ms, {conv: ms}, rel err, equal share)], each case
    held to its plain version first."""
    from singlehdr_tpu_torch.ops.cuda import enc_pool_cuda, unet_stage_cuda

    kernels = {"unet_stage2": (unet_stage_cuda.unet_stage2, unet_stage_cuda.unet_stage2_plain),
               "encoder_stage2": (enc_pool_cuda.encoder_stage2, enc_pool_cuda.encoder_stage2_plain)}
    rows = []
    for name, label, args in cases:
        for t in args:  # this variant's packing
            t.__dict__.pop("_cached", None)
        kernel, plain = kernels[name]
        got, want = kernel(*args), plain(*args)
        rel = max(((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
                  for a, w in zip(got, want))
        equal = min((a == w).float().mean().item() for a, w in zip(got, want))
        if not (rel <= cs.KERNEL_BF16_REL_TOL and equal >= cs.KERNEL_BF16_MIN_EQUAL):
            raise AssertionError(f"{name} {label}: rel {rel:.3e}, {equal:.2%} equal")
        stage = cs.device_ms(lambda: kernel(*args))
        convs = {conv: cs.device_ms(fn) for conv, fn, _, _ in cs.conv_launches(name, args)}
        rows.append((name, label, stage, convs, rel, equal))
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
        print("conv_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from singlehdr_tpu_torch.models import build_pipeline
    from singlehdr_tpu_torch.ops.cuda import _build
    from singlehdr_tpu_torch.precision import use_full_f32

    use_full_f32()
    t0 = time.perf_counter()
    tree = _build.lib()
    libs = {TREE: tree, **build_variants([n for n in names if n in SOURCE_EDITS])}
    print(f"{cs.card_line()}  built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    pipe = build_pipeline(seed=cs.SEED, device=dev)
    with torch.no_grad():  # not inference tensors: the packing is cached on them
        cases = [c for c in cs.kernel_cases(pipe, dev, torch.bfloat16)
                 if c[0] in ("unet_stage2", "encoder_stage2")]
    results = []
    with torch.inference_mode():
        for name in [TREE, *names, TREE]:
            _build._lib = libs.get(name, tree)
            undo = sixteen_channel_plan() if name == "sixteen_channel_rgb" else None
            try:
                rows = time_cases(cases, cs)
            finally:
                _build._lib = tree
                if undo:
                    undo()
            sums = {}
            for kname, label, stage, _, _, _ in rows:
                if "odd" not in label:
                    sums[kname] = sums.get(kname, 0.0) + stage
            print(f"== {name}: main-path sums " +
                  ", ".join(f"{k} {v:.4f} ms" for k, v in sums.items()), flush=True)
            for kname, label, stage, convs, rel, equal in rows:
                print(f"  {kname:15s} {label:34s} {stage:.4f} ms  " +
                      "  ".join(f"{c} {ms:.4f}" for c, ms in convs.items()) +
                      f"  rel {rel:.2e} equal {equal:.2%}", flush=True)
            results.append({"variant": name, "sums_ms": sums, "cases": [
                {"kernel": k, "label": lb, "stage_ms": st, "conv_ms": cv, "rel": r, "equal": e}
                for k, lb, st, cv, r, e in rows]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": cs.card_line(), "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
