"""Large-image inference: overlapping tiles, and rows split over devices
(counterparts of ``TiledPredictor`` and ``shard_spatial`` in
``singlehdr_tpu.tiled``).

``TiledPredictor``: the image is split into ``tile``-sized tiles with ``halo`` overlap, the
pipeline's stages run tile by tile, and the overlaps are blended with linear
feathering.  The inverse CRF is global image state (the Linearization-Net
pools over the whole image), so it is estimated once, from an ``INTER_AREA``
view of the whole image, and applied to every tile; the convolutional stages
(deq, hal, ref) are local up to their receptive field, which the halo
covers.  Every tile has one shape, so any image size runs the same kernels
at the same shapes.

``shard_spatial``: the exact whole pipeline with the image's rows split over
the S bands of a spatial mesh, one rank each; every conv, pool and resize
exchanges its halo rows with the neighbouring bands, the fused kernels run
on bands extended by their reach, and lin's pooled features are summed over
the bands (``parallel.mesh``).  No rank runs the whole image.
"""

from __future__ import annotations

import numpy as np
import torch

from singlehdr_tpu_torch.models.layers import mesh_bound
from singlehdr_tpu_torch.ops.color import bgr_to_rgb
from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf
from singlehdr_tpu_torch.ops.masks import highlight_alpha
from singlehdr_tpu_torch.parallel.mesh import band_rows, gather_rows

# every band's height divides by hal's five 2x2 pools, so that each pool's
# grid keeps the band boundaries
BAND_MULTIPLE = 32


def _feather_weights(size: int, halo: int) -> np.ndarray:
    """1-D blend profile: 0..1 ramp across the halo, 1 in the interior."""
    w = np.ones(size, np.float32)
    if halo > 0:
        ramp = (np.arange(halo, dtype=np.float32) + 1.0) / (halo + 1.0)
        w[:halo] = ramp
        w[-halo:] = ramp[::-1]
    return w


def tile_origins(n: int, tile: int, stride: int) -> list:
    """Tile starts along one axis of length ``n``: every ``stride``, plus a
    last tile flush with the end."""
    starts = list(range(0, max(n - tile, 0) + 1, stride))
    if starts[-1] + tile < n:
        starts.append(n - tile)
    return starts


class TiledPredictor:
    """Constant-shape tiled inference over arbitrarily large images.

    Args:
      pipeline: a ``ReverseCameraPipeline`` on its device (``models.build_pipeline``);
        it runs in eval mode on that device, in its compute dtype.
      tile: tile edge, a multiple of 64.
      halo: overlap between tiles (>= the conv stacks' receptive-field radius).
      invcrf_view: edge of the whole-image view the inverse CRF is estimated on.
      use_refinement: False returns each tile's A_pred (``ref`` does not run).
    """

    def __init__(self, pipeline: torch.nn.Module, tile: int = 512, halo: int = 64,
                 invcrf_view: int = 256, use_refinement: bool = True):
        if tile % 64:
            raise ValueError("tile must be a multiple of 64")
        self.pipeline = pipeline.eval()
        self.device = next(pipeline.parameters()).device
        self.tile, self.halo, self.invcrf_view = tile, halo, invcrf_view
        self.use_refinement = use_refinement

    def _tensor(self, rgb01: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(rgb01, np.float32))
        return x.to(self.device).permute(2, 0, 1).unsqueeze(0).contiguous()

    def _run_tile(self, tile_ldr: np.ndarray, invcrf: torch.Tensor) -> np.ndarray:
        """The pipeline's stages on one [t, t, 3] tile with the global curve."""
        p = self.pipeline
        with torch.inference_mode():
            c = torch.clamp(p.deq(self._tensor(tile_ldr)), 0.0, 1.0)
            b = apply_rf(c, invcrf)
            a = b + highlight_alpha(b) * bgr_to_rgb(p.hal(b))
            out = p.ref(torch.cat([a, b, c], dim=1)) if self.use_refinement else a
            return out[0].permute(1, 2, 0).cpu().numpy()

    def global_invcrf(self, rgb01: np.ndarray) -> torch.Tensor:
        """deq -> clip -> lin on an ``invcrf_view``^2 ``INTER_AREA`` view."""
        import cv2

        view = cv2.resize(rgb01, (self.invcrf_view, self.invcrf_view),
                          interpolation=cv2.INTER_AREA)
        with torch.inference_mode():
            c = torch.clamp(self.pipeline.deq(self._tensor(view)), 0.0, 1.0)
            return self.pipeline.lin(c)

    def __call__(self, rgb01: np.ndarray) -> np.ndarray:
        """[h, w, 3] float32 RGB in [0, 1] -> [h, w, 3] float32 HDR."""
        h, w = rgb01.shape[:2]
        t, halo = self.tile, self.halo
        if h <= t and w <= t:
            x = np.pad(rgb01, ((0, t - h), (0, t - w), (0, 0)), mode="symmetric")
            return self._run_tile(x, self.global_invcrf(x))[:h, :w]

        invcrf = self.global_invcrf(rgb01)
        acc = np.zeros((h, w, 3), np.float32)
        norm = np.zeros((h, w, 1), np.float32)
        wt = _feather_weights(t, halo)
        blend = (wt[:, None] * wt[None, :])[..., None]
        for y in tile_origins(h, t, t - 2 * halo):
            for x0 in tile_origins(w, t, t - 2 * halo):
                tile_in = rgb01[y:y + t, x0:x0 + t]
                ph, pw = t - tile_in.shape[0], t - tile_in.shape[1]
                if ph or pw:
                    tile_in = np.pad(tile_in, ((0, ph), (0, pw), (0, 0)), mode="symmetric")
                tile_out = self._run_tile(tile_in, invcrf)
                th, tw = min(t, h - y), min(t, w - x0)
                acc[y:y + th, x0:x0 + tw] += tile_out[:th, :tw] * blend[:th, :tw]
                norm[y:y + th, x0:x0 + tw] += blend[:th, :tw]
        return acc / np.maximum(norm, 1e-8)


def shard_spatial(pipeline: torch.nn.Module, rgb01: np.ndarray, mesh,
                  use_refinement: bool = True) -> np.ndarray:
    """The whole pipeline on ``rgb01`` ([h, w, 3] float32 RGB in [0, 1]) with
    its rows split over ``mesh``'s S bands -> the [h, w, 3] float32 HDR on
    every rank of the data index.

    Every rank of a data index calls it with the same photo; each runs the
    ``pipeline`` (a ``ReverseCameraPipeline`` on this rank's device, in eval
    mode) on its band of h / S rows and the halo rows its layers exchange,
    and the bands' outputs are gathered.  h must be a multiple of S * 32, so
    that every band's rows divide by hal's five pools (the JAX function asks
    for S * 64, more than its nets need)."""
    h = rgb01.shape[0]
    if h % (mesh.spatial * BAND_MULTIPLE):
        raise ValueError(f"shard_spatial needs a height that divides by {mesh.spatial} x "
                         f"{BAND_MULTIPLE}, got {h}")
    device = next(pipeline.parameters()).device
    band = band_rows(mesh, np.ascontiguousarray(rgb01, np.float32)[None])
    x = torch.from_numpy(np.ascontiguousarray(band)).to(device).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode(), mesh_bound(pipeline.eval(), mesh):
        hdr = gather_rows(pipeline(x, use_refinement=use_refinement).hdr, mesh)
    return hdr[0].permute(1, 2, 0).cpu().numpy()
