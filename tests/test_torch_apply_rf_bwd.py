"""K1-bwd's design, simulated in numpy on the CPU (the CUDA kernel runs only on
the card; ``chip_smoke.py`` phase 8 holds it to its plain version there).

- The block -> pixel map of ``csrc/apply_rf.cu``, which K1 and K1-bwd share
  (``k1_block_steps``; ``tests/test_torch_ops.py`` runs K1's through it):
  every pixel is read once, its gx written once, its weights added into grf
  once, for any n, batch, grid width and alignment of x, g and gx.
- The curve gradient's accumulation order, in float32 (``simulate_grf``):
  per warp step, lanes grouped by bin, each group summed by its lowest lane
  in lane order (a run of 32 lanes of one bin: an xor tree), one add a bin
  into the warp's histogram; pixels with i0 == i1 (bins 0 and k - 1) summed
  in each lane's registers and added by an xor tree at the end; then the
  warps' histograms in warp order, then the blocks' rows in the sum
  kernel's order.  It asserts that no two lanes of a warp add to one bin in
  one step, which is what lets the histograms go without atomics, and is
  held to ``apply_rf_bwd_plain`` in float64 within ``BWD_REL_TOL`` of
  max|grf| and to ``jax.grad`` of the JAX package's ``apply_rf``.

The simulation reads its constants (threads, loads in flight, warps) from the
kernel's source.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlehdr_tpu.ops import curves as jcurves
from singlehdr_tpu_torch.ops.cuda import apply_rf_cuda
from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf_bwd_plain

SOURCE = Path(apply_rf_cuda.__file__).resolve().parents[2] / "csrc" / "apply_rf.cu"
BWD_REL_TOL = 1e-5  # chip_smoke.BWD_REL_TOL: grf vs the float64 plain version


def cu_constant(name: str) -> int:
    """The value of ``constexpr int name = ...;`` in csrc/apply_rf.cu."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE.read_text()).group(1)
    if "kThreads" in expr:
        expr = expr.replace("kThreads", str(cu_constant("kThreads")))
    num, _, den = expr.partition("/")
    return int(num) // int(den or 1)


THREADS = cu_constant("kThreads")
VEC = cu_constant("kVec")          # K1: float4 loads a thread has in flight
BWD_VEC = cu_constant("kBwdVec")   # K1-bwd: float4 loads each of x and g
WARPS = cu_constant("kBwdWarps")
SUM_PARTS = cu_constant("kSumParts")  # threads that sum one bin's block rows
LANES = 32


def k1_block_steps(n: int, bps: int, bi: int, offsets, vec: int) -> list:
    """The pixels block ``bi`` of one sample takes in a K1 or K1-bwd launch,
    step by step in the block's order: each step an int64 array [THREADS] of
    pixel indices, -1 where a thread has none.  ``offsets``: where each array
    the kernel walks (x and out; x, g and gx) starts this sample, in floats
    past a 16-byte boundary; ``vec``: the float4 loads a thread has in flight.
    Arrays of different alignment take the scalar walk."""
    tid = np.arange(THREADS)
    xa = 4 * offsets[0] % 16
    if any(4 * o % 16 != xa for o in offsets[1:]):
        per = -(-n // bps)
        p1 = min(n, (bi + 1) * per)
        return [np.where(p0 + tid < p1, p0 + tid, -1) for p0 in range(bi * per, p1, THREADS)]
    head = min(n, ((16 - xa) % 16) >> 2)
    units = (n - head) >> 2
    per = -(-units // bps)
    u0, u1 = bi * per, min(units, bi * per + per)
    steps = []
    if bi == 0:
        steps.append(np.where(tid < head, tid, -1))
    if bi == bps - 1:
        tail = head + 4 * units + tid
        steps.append(np.where(tail < n, tail, -1))
    for r0 in range(u0, u1, vec * THREADS):
        for j in range(vec):
            q = r0 + j * THREADS + tid
            steps += [np.where(q < u1, head + 4 * q + c, -1) for c in range(4)]
    return steps


def bwd_offsets(s: int, n: int, x_off: int, g_off: int, gx_off: int, need_x: bool) -> tuple:
    """The arrays whose alignment K1-bwd's walk depends on, for sample s."""
    return (x_off + s * n, g_off + s * n) + ((gx_off + s * n,) if need_x else ())


def _lerp_f32(x: np.ndarray, k: int):
    """(frac, i0, i1) as the kernel computes them, in float32."""
    y = x * np.float32(k - 1)
    y0 = np.floor(y)
    frac = y - y0
    iy = np.clip(y0, -1, k).astype(np.int64)
    return frac, np.clip(iy, 0, k - 1), np.clip(iy + 1, 0, k - 1)


def _xor_tree(v: np.ndarray) -> np.ndarray:
    """The 5-step __shfl_xor_sync tree over a warp's 32 float32 values: every
    lane ends with the same sum."""
    lanes = np.arange(LANES)
    for d in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ d]
    return v


def warp_step(hist: np.ndarray, edges: np.ndarray, pix: np.ndarray, x: np.ndarray,
              g: np.ndarray, k: int) -> None:
    """One warp step of ``bwd_pixel`` / ``warp_bin_add``: 32 lanes, one pixel
    each (-1: none).  A pixel with i0 == i1 adds its two weights into its
    lane's own sum for bin 0 or bin k - 1 (``edges`` [2, 32] float32); the
    others go into the warp's histogram ``hist`` [k] float32."""
    valid = pix >= 0
    p = np.where(valid, pix, 0)
    xv, gv = x[p], g[p]
    frac, i0, i1 = _lerp_f32(xv, k)
    w0 = (np.float32(1) - frac) * gv
    w1 = frac * gv
    merged = i0 == i1
    for side, at in ((0, 0), (1, k - 1)):
        lanes = valid & merged & (i0 == at)
        edges[side, lanes] = edges[side, lanes] + (w0 + w1)[lanes]
    key = np.where(valid & ~merged, i0, -1)
    sums = {}  # key -> (leader lane, sum of w0, sum of w1)
    if (key >= 0).all() and (key == key[0]).all():  # a run of one bin: the tree
        sums[key[0]] = (0, _xor_tree(w0)[0], _xor_tree(w1)[0])
    for kv in np.unique(key[key >= 0]) if not sums else ():
        members = np.flatnonzero(key == kv)  # ascending: the lowest lane leads and sums
        s0, s1 = w0[members[0]], w1[members[0]]
        for lane in members[1:]:
            s0, s1 = s0 + w0[lane], s1 + w1[lane]
        sums[kv] = (members[0], s0, s1)
    # what lets the histogram go without atomics: in each of the two adds of
    # a step, no two lanes write one bin
    first = list(sums)
    second = [kv + 1 for kv in sums]
    assert len(set(first)) == len(first) and len(set(second)) == len(second)
    assert max(second, default=0) <= k - 1
    assert all(valid[lead] and key[lead] == kv for kv, (lead, _, _) in sums.items())
    for kv, (_, s0, _) in sums.items():
        hist[kv] = hist[kv] + s0
    for kv, (_, _, s1) in sums.items():
        hist[kv + 1] = hist[kv + 1] + s1


def simulate_grf(x: np.ndarray, g: np.ndarray, k: int, bps: int, offsets=(0, 0, 0),
                 need_x: bool = True) -> np.ndarray:
    """grf [b, k] float32 as K1-bwd sums it: warp steps into warp histograms
    and lane edge sums, the edge sums' xor trees into bins 0 and k - 1, warps
    in order into a block row; block rows p, p + SUM_PARTS, ... in order into
    part p, and the parts in order into grf."""
    b, n = x.shape
    grf = np.zeros((b, k), np.float32)
    for s in range(b):
        rows = []
        for bi in range(bps):
            hists = np.zeros((WARPS, k), np.float32)
            edges = np.zeros((WARPS, 2, LANES), np.float32)
            for step in k1_block_steps(n, bps, bi, bwd_offsets(s, n, *offsets, need_x), BWD_VEC):
                for w in range(WARPS):
                    lanes = step[w * LANES:(w + 1) * LANES]
                    if (lanes >= 0).any():
                        warp_step(hists[w], edges[w], lanes, x[s], g[s], k)
            for w in range(WARPS):
                hists[w, 0] = hists[w, 0] + _xor_tree(edges[w, 0])[0]
                hists[w, k - 1] = hists[w, k - 1] + _xor_tree(edges[w, 1])[0]
            row = hists[0].copy()
            for w in range(1, WARPS):
                row = row + hists[w]
            rows.append(row)
        parts = np.zeros((SUM_PARTS, k), np.float32)  # apply_rf_bwd_sum_kernel
        for p in range(SUM_PARTS):
            for row in rows[p::SUM_PARTS]:
                parts[p] = parts[p] + row
        grf[s] = parts[0]
        for p in range(1, SUM_PARTS):
            grf[s] = grf[s] + parts[p]
    return grf


def test_simulation_constants_are_the_kernels():
    """The simulation's widths are read from the source; the wrapper's agree."""
    assert (THREADS, WARPS) == (apply_rf_cuda.THREADS, apply_rf_cuda.THREADS // LANES)
    assert cu_constant("kBwdMaxBins") == apply_rf_cuda.BWD_MAX_BINS
    assert VEC >= 1 and BWD_VEC >= 1


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_k1_bwd_block_map_touches_every_pixel_once(b, r):
    """For n % 4 = r, b samples (whose bases s * n move the alignment), x, g
    and gx at a 16-byte boundary, past it, or at different offsets, the grid
    of ``blocks_per_sample`` and a few forced widths, with both gradients,
    gx only and grf only: every pixel is read once; with gx, its gx is
    written once; with grf, its weights go into grf once (the same steps)."""
    n = 3 * 24 * 24 + 2 * 4096 + r
    offsets = ((0, 0, 0), (1, 1, 1), (3, 3, 3), (0, 1, 0), (2, 2, 1), (1, 3, 2))
    for bps in {apply_rf_cuda.blocks_per_sample(b, n, 132), 1, 5}:
        for need_x, need_rf in ((True, True), (True, False), (False, True)):
            for off in offsets:
                reads = np.zeros((b, n), np.int64)
                for s in range(b):
                    for bi in range(bps):
                        for step in k1_block_steps(n, bps, bi, bwd_offsets(s, n, *off, need_x),
                                                   BWD_VEC):
                            np.add.at(reads[s], step[step >= 0], 1)
                assert (reads == 1).all(), (bps, need_x, need_rf, off)


def _hot_inputs(b: int, n: int, seed: int, kind: str, k: int = 1024):
    """x with hot bins: saturated runs, out-of-range values, the 8-bit grid."""
    rs = np.random.RandomState(seed)
    if kind == "saturated":
        x = np.ones((b, n), np.float32)
    elif kind == "ldr":  # an 8-bit image: j / 255, smooth, with clipped highlights
        ramp = np.round(np.linspace(0, 300, n))[None] + rs.randint(-3, 4, (b, n))
        x = (np.clip(ramp, 0, 255) / 255).astype(np.float32)
    else:  # chip_smoke.k1_bwd_inputs' mix
        x = (rs.rand(b, n) * 1.4 - 0.2).astype(np.float32)
        x[:, : n // 5] = 1.0
        x[:, n // 5: n // 4] = 0.0
        x[:, n // 4: n // 4 + n // 20] = rs.randint(0, 1024, (b, n // 20)) / np.float32(1023)
    rf = np.sort(rs.rand(b, k), axis=1).astype(np.float32)
    return x, rf, rs.randn(b, n).astype(np.float32)


@pytest.mark.parametrize("kind,b,n,bps,offsets,need_x", [
    ("mix", 3, 3 * 40 * 40 + 2, None, (0, 0, 0), True),
    ("saturated", 2, 3 * 24 * 24 + 1, 3, (1, 1, 1), False),
    ("ldr", 2, 3 * 40 * 40 + 3, 7, (2, 2, 2), False),
    ("mix", 1, 2051, 2, (0, 1, 0), True),   # x and g of different alignment: the scalar walk
])
def test_k1_bwd_accumulation_order_matches_float64_plain(kind, b, n, bps, offsets, need_x):
    """The simulated float32 grf, summed in the kernel's order, is within
    BWD_REL_TOL of max|grf| of the plain version in float64 and of jax.grad
    of the JAX package's apply_rf; the gx formula rounds as the plain
    version does (bit-equal)."""
    x, rf, g = _hot_inputs(b, n, seed=n, kind=kind)
    k = rf.shape[1]
    bps = bps or apply_rf_cuda.blocks_per_sample(b, n, 132)
    got = simulate_grf(x, g, k, bps, offsets, need_x)

    _, want = apply_rf_bwd_plain(*(torch.from_numpy(a).double() for a in (x, rf, g)), False, True)
    want = want.numpy()
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= BWD_REL_TOL * scale

    jgrf = jax.grad(lambda c: jnp.sum(jcurves.apply_rf(jnp.asarray(x), c, impl="xla") * g))(
        jnp.asarray(rf))
    assert np.abs(got - np.asarray(jgrf)).max() <= BWD_REL_TOL * scale

    frac, i0, i1 = _lerp_f32(x, k)
    gx = (np.float32(k - 1) * (np.take_along_axis(rf, i1, 1) - np.take_along_axis(rf, i0, 1))) * g
    plain_gx, _ = apply_rf_bwd_plain(*(torch.from_numpy(a) for a in (x, rf, g)), True, False)
    np.testing.assert_array_equal(gx, plain_gx.numpy())
