"""HDR-Real record converter CLI (counterpart of
``singlehdr_tpu.cli.convert_records``; the reference's convert_to_tf_record.py).

Slices paired HDR_gt/*.hdr + LDR_in/*.jpg into filtered 256^2 patch records,
the same shards the JAX package writes:

  python -m singlehdr_tpu_torch.cli.convert_records --dir /data/HDR-Real --out ./records

A host-only tool (numpy and cv2): it takes no ``--device``.
"""

from __future__ import annotations

import argparse
import glob
import os

from singlehdr_tpu_torch.data.records import convert_hdr_real


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert HDR-Real pairs to records")
    p.add_argument("--dir", type=str, required=True, help="dir with HDR_gt/ and LDR_in/")
    p.add_argument("--out", type=str, default="records")
    p.add_argument("--prefix", type=str, default="train")
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--patch_stride", type=int, default=64)
    return p


def run(args) -> int:
    """Convert; returns the number of records written."""
    hdrs = sorted(glob.glob(os.path.join(args.dir, "HDR_gt", "*.hdr")))
    ldrs = sorted(glob.glob(os.path.join(args.dir, "LDR_in", "*.jpg")))
    if not hdrs:
        raise FileNotFoundError(f"no HDR_gt/*.hdr under {args.dir}")
    n = convert_hdr_real(hdrs, ldrs, args.out, prefix=args.prefix, patch_size=args.patch_size,
                         patch_stride=args.patch_stride)
    print(f"wrote {n} patch records to {args.out}")
    return n


if __name__ == "__main__":
    run(build_parser().parse_args())
