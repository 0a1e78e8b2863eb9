"""The plain reference of the four nets, the VGG16 of the perceptual loss,
the joint losses and Adam, in float32 (a frozen copy of the published
architecture, written from the paper and the TF2 reference code; it
imports nothing of the measured program).

Liu et al., "Single-Image HDR Reconstruction by Learning to Reverse the
Camera Pipeline", CVPR 2020 (arXiv:2004.01179), as ShinYwings/SingleHDR-tf2
builds it:

    C = clip(deq(ldr), 0, 1)                 residual U-Net, tanh residual
    g = lin(C)                               93-channel features, ResNet, EMoR PCA
    B = apply_rf(C, g)                       per-sample 1-D LUT, linear lerp
    A = B + alpha(B) * rgb(hal(B))           VGG16-layout encoder-decoder
    hdr = relu(A + ref(concat[A, B, C]))     residual U-Net

Parameters are one flat dict keyed like the measured program's
``state_dict`` (``param_spec``), so the benchmark makes one set of weights
and hands the same tensors to both sides.  NCHW throughout; TF 'SAME'
padding.  Every convolution goes through a ``Compute``, which is plain
float32 here; ``hdrbench.reference.precision`` gives the
lower precisions of the controls.
"""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

LEAKY = 0.1
BN_EPS = 1e-3
HIGHLIGHT_T = 0.12
VGG_MEAN_BGR = (103.939, 116.779, 123.68)
HIST_BINS = (4, 8, 16)
N_PCA = 11
_EMOR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "emor.npz")


class Compute:
    """Plain float32 convolutions; ``scope()`` is the context the nets'
    compute-dtype parts run in (nothing here)."""

    def scope(self):
        return contextlib.nullcontext()

    def conv(self, x, w, b=None, stride=1):
        return conv_same(x, w, b, stride)


F32 = Compute()


# ---------------------------------------------------------------- parameters

def _unet_spec(prefix, cin, bottleneck):
    spec = {}

    def conv(name, ci, co, k):
        spec[f"{prefix}.{name}.weight"] = ("conv", (co, ci, k, k))
        spec[f"{prefix}.{name}.bias"] = ("bias", (co,))

    conv("stem1", cin, 16, 7)
    conv("stem2", 16, 16, 7)
    c = 16
    for name, f, k in (("down2", 32, 5), ("down3", 64, 3), ("down4", 128, 3),
                       ("bottleneck", bottleneck, 3)):
        conv(f"{name}.conv1", c, f, k)
        conv(f"{name}.conv2", f, f, k)
        c = f
    for name, f in (("up4", 128), ("up3", 64), ("up2", 32), ("up1", 16)):
        conv(f"{name}.conv1", c, f, 3)
        conv(f"{name}.conv2", 2 * f, f, 3)
        c = f
    conv("head", 16, 3, 3)
    return spec


def _bn(spec, name, c):
    spec[f"{name}.weight"] = ("bn_weight", (c,))
    spec[f"{name}.bias"] = ("bn_bias", (c,))
    spec[f"{name}.running_mean"] = ("bn_mean", (c,))
    spec[f"{name}.running_var"] = ("bn_var", (c,))


_LIN_BLOCKS = (("res1", 64, (64, 64, 256), 1, True), ("res2", 256, (64, 64, 256), 1, False),
               ("res3", 256, (64, 64, 256), 1, False), ("res4", 256, (128, 128, 512), 2, True),
               ("res5", 512, (128, 128, 512), 1, False))
_HAL_ENC = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_VGG = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128), ("conv2_2", 128, 128),
        ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256))
_VGG_POOL_AFTER = ("conv1_2", "conv2_2", "conv3_3")


def _lin_spec():
    p = "lin.crf_feature_net"
    spec = {f"{p}.stem.weight": ("conv", (64, 93, 7, 7)), f"{p}.stem.bias": ("bias", (64,))}
    _bn(spec, f"{p}.stem_bn", 64)
    for name, cin, (f1, f2, f3), _, proj in _LIN_BLOCKS:
        if proj:
            spec[f"{p}.{name}.proj_conv.weight"] = ("conv", (f3, cin, 1, 1))
            _bn(spec, f"{p}.{name}.proj_bn", f3)
        for i, (ci, co, k) in enumerate(((cin, f1, 1), (f1, f2, 3), (f2, f3, 1))):
            spec[f"{p}.{name}.conv{i + 1}.weight"] = ("conv", (co, ci, k, k))
            _bn(spec, f"{p}.{name}.bn{i + 1}", co)
    spec["lin.pca_head.weight"] = ("dense", (N_PCA, 512))
    spec["lin.pca_head.bias"] = ("bias", (N_PCA,))
    return spec


def _hal_spec():
    spec = {"hal.preproc_mean": ("vgg_mean", (3,))}
    cin = 3
    for i, (f, n) in enumerate(_HAL_ENC):
        for j in range(n):
            spec[f"hal.enc{i + 1}.conv{j + 1}.weight"] = ("conv", (f, cin if j == 0 else f, 3, 3))
            spec[f"hal.enc{i + 1}.conv{j + 1}.bias"] = ("bias", (f,))
        cin = f
    spec["hal.latent_conv.weight"] = ("conv", (512, 512, 3, 3))
    spec["hal.latent_conv.bias"] = ("bias", (512,))
    _bn(spec, "hal.latent_bn", 512)
    for i in range(len(_HAL_ENC), 0, -1):
        f = _HAL_ENC[i - 1][0]
        spec[f"hal.dec{i}.conv.weight"] = ("conv", (f, cin, 3, 3))
        spec[f"hal.dec{i}.conv.bias"] = ("bias", (f,))
        _bn(spec, f"hal.dec{i}.bn", f)
        spec[f"hal.skip{i}.conv.weight"] = ("conv", (f, 2 * f, 1, 1))
        spec[f"hal.skip{i}.conv.bias"] = ("bias", (f,))
        cin = f
    spec["hal.head_conv.weight"] = ("conv", (3, 64, 1, 1))
    spec["hal.head_conv.bias"] = ("bias", (3,))
    _bn(spec, "hal.head_bn", 3)
    spec["hal.skip0.conv.weight"] = ("conv", (3, 6, 1, 1))
    spec["hal.skip0.conv.bias"] = ("bias", (3,))
    return spec


def param_spec(nets) -> dict:
    """{key: (kind, shape)} of ``nets`` (names among deq, lin, hal, ref,
    vgg), in a fixed order; keys as the program's state_dict has them (the
    VGG's without a prefix)."""
    spec = {}
    for net in nets:
        if net == "deq":
            spec.update(_unet_spec("deq.unet", 3, 256))
        elif net == "lin":
            spec.update(_lin_spec())
        elif net == "hal":
            spec.update(_hal_spec())
        elif net == "ref":
            spec.update(_unet_spec("ref.unet", 9, 128))
        elif net == "vgg":
            for name, cin, cout in _VGG:
                spec[f"{name}.weight"] = ("vgg_conv", (cout, cin, 3, 3))
                spec[f"{name}.bias"] = ("zero", (cout,))
        else:
            raise ValueError(f"unknown net {net!r}")
    return spec


# ---------------------------------------------------------------- primitives

def same_pads(n, k, s):
    """TF 'SAME' (low, high) padding: the odd element at the high end."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x, w, b=None, stride=1):
    kh, kw = w.shape[-2:]
    pt, pb = same_pads(x.shape[2], kh, stride)
    pl, pr = same_pads(x.shape[3], kw, stride)
    if pt == pb and pl == pr:
        return F.conv2d(x, w, b, stride=stride, padding=(pt, pl))
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, b, stride=stride)


def leaky(x):
    return F.leaky_relu(x, LEAKY)


def batch_norm(x, p, name, training):
    """Keras BatchNormalization: eval with the running statistics, train with
    the biased batch statistics (the running ones are not updated here)."""
    return F.batch_norm(x, None if training else p[f"{name}.running_mean"],
                        None if training else p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], training, 0.0, BN_EPS)


def upsample_x2(x):
    """tf.image.resize bilinear, half-pixel centres, at exactly x2."""
    for dim in (2, 3):
        n = x.shape[dim]
        lo = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
        hi = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)
        pair = torch.stack([0.25 * lo + 0.75 * x, 0.75 * x + 0.25 * hi], dim=dim + 1)
        shape = list(x.shape)
        shape[dim] *= 2
        x = pair.reshape(shape)
    return x


def max_pool_same(x, window, stride):
    pt, pb = same_pads(x.shape[2], window, stride)
    pl, pr = same_pads(x.shape[3], window, stride)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def apply_rf(x, rf):
    """Per-sample LUT: y = (k-1) x, lerp between rf[clip(floor y)] and
    rf[clip(floor y + 1)]."""
    b, k = rf.shape
    y = x.reshape(b, -1) * (k - 1)
    y0 = torch.floor(y)
    frac = y - y0
    i0 = y0.long().clamp(0, k - 1)
    i1 = (y0.long() + 1).clamp(0, k - 1)
    v0, v1 = torch.gather(rf, 1, i0), torch.gather(rf, 1, i1)
    return (v0 + frac * (v1 - v0)).reshape(x.shape)


def vgg_preprocess(rgb01, mean):
    return torch.flip(rgb01 * 255.0, dims=(1,)) - mean.reshape(1, -1, 1, 1)


def mu_tonemap(x, mu=10.0):
    return torch.log1p(mu * x) / math.log1p(mu)


def highlight_alpha(x):
    m = x.amax(dim=1, keepdim=True)
    return torch.clamp((m - 1.0 + HIGHLIGHT_T) / HIGHLIGHT_T, 0.0, 1.0).expand_as(x)


# ---------------------------------------------------------------- the nets

def unet_stage(c: Compute, x, p, a, b):
    """Two leaky convs; returns (avg_pool_2x2(act), act)."""
    act = leaky(c.conv(leaky(c.conv(x, p[f"{a}.weight"], p[f"{a}.bias"])),
                       p[f"{b}.weight"], p[f"{b}.bias"]))
    return F.avg_pool2d(act, 2), act


def unet(c: Compute, x, p, prefix):
    h, s1 = unet_stage(c, x, p, f"{prefix}.stem1", f"{prefix}.stem2")
    h, s2 = unet_stage(c, h, p, f"{prefix}.down2.conv1", f"{prefix}.down2.conv2")
    h, s3 = unet_stage(c, h, p, f"{prefix}.down3.conv1", f"{prefix}.down3.conv2")
    h, s4 = unet_stage(c, h, p, f"{prefix}.down4.conv1", f"{prefix}.down4.conv2")
    _, h = unet_stage(c, h, p, f"{prefix}.bottleneck.conv1", f"{prefix}.bottleneck.conv2")
    for name, skip in (("up4", s4), ("up3", s3), ("up2", s2), ("up1", s1)):
        h = leaky(c.conv(upsample_x2(h), p[f"{prefix}.{name}.conv1.weight"],
                         p[f"{prefix}.{name}.conv1.bias"]))
        h = leaky(c.conv(torch.cat([h, skip], dim=1), p[f"{prefix}.{name}.conv2.weight"],
                         p[f"{prefix}.{name}.conv2.bias"]))
    return c.conv(h, p[f"{prefix}.head.weight"], p[f"{prefix}.head.bias"])


def deq(c: Compute, ldr, p):
    """ldr + tanh(residual); the caller clips."""
    with c.scope():
        return ldr + torch.tanh(unet(c, ldr, p, "deq.unet"))


def refine(c: Compute, abc, p):
    with c.scope():
        return torch.relu(abc[:, 0:3] + unet(c, abc, p, "ref.unet"))


def sobel(img):
    """tf.image.sobel_edges: REFLECT pad 1, channels (dy, dx) interleaved."""
    b, ch, h, w = img.shape
    xp = F.pad(img, (1, 1, 1, 1), mode="reflect")
    sw = xp[:, :, :, 0:w] + 2.0 * xp[:, :, :, 1:w + 1] + xp[:, :, :, 2:w + 2]
    dy = sw[:, :, 2:h + 2] - sw[:, :, 0:h]
    sh = xp[:, :, 0:h] + 2.0 * xp[:, :, 1:h + 1] + xp[:, :, 2:h + 2]
    dx = sh[:, :, :, 2:w + 2] - sh[:, :, :, 0:w]
    return torch.stack([dy, dx], dim=2).reshape(b, 2 * ch, h, w)


def soft_histogram(img, bins):
    b, ch, h, w = img.shape
    centers = (2.0 * torch.arange(1, bins + 1, dtype=img.dtype, device=img.device) - 1.0) / (2.0 * bins)
    resp = torch.clamp(1.0 - torch.abs(img[:, None] - centers[None, :, None, None, None]) * bins, min=0.0)
    return resp.reshape(b, bins * ch, h, w)


def lin_features(img):
    """[img, sobel (6), histograms at 4, 8, 16 bins] -> 93 channels."""
    return torch.cat([img, sobel(img)] + [soft_histogram(img, n) for n in HIST_BINS], dim=1)


def lin_stem(c: Compute, img, p, training=False):
    """The feature stack, the 7x7/2 stem, its BN and ReLU."""
    q = "lin.crf_feature_net"
    h = c.conv(lin_features(img), p[f"{q}.stem.weight"], p[f"{q}.stem.bias"], stride=2)
    return torch.relu(batch_norm(h, p, f"{q}.stem_bn", training))


def load_inverse_emor():
    z = np.load(_EMOR)
    return z["g0"].astype(np.float32), z["hinv"].astype(np.float32)


def lin(c: Compute, img, p, training=False, emor=None):
    """The inverse CRF [b, 1024]: features, ResNet, PCA head, monotone."""
    q = "lin.crf_feature_net"
    with c.scope():  # the features in the compute precision; the head and the curve f32
        h = max_pool_same(lin_stem(c, img, p, training), 3, 2)
        for name, _, _, stride, proj in _LIN_BLOCKS:
            r = f"{q}.{name}"
            short = batch_norm(c.conv(h, p[f"{r}.proj_conv.weight"], None, stride), p,
                               f"{r}.proj_bn", training) if proj else h
            t = torch.relu(batch_norm(c.conv(h, p[f"{r}.conv1.weight"], None, stride), p, f"{r}.bn1",
                                      training))
            t = torch.relu(batch_norm(c.conv(t, p[f"{r}.conv2.weight"]), p, f"{r}.bn2", training))
            t = batch_norm(c.conv(t, p[f"{r}.conv3.weight"]), p, f"{r}.bn3", training)
            h = torch.relu(short + t)
        h = h.mean(dim=(2, 3))
    w = F.linear(h, p["lin.pca_head.weight"], p["lin.pca_head.bias"])
    g0, hinv = emor if emor is not None else load_inverse_emor()
    g0 = torch.as_tensor(g0, device=w.device)
    hinv = torch.as_tensor(hinv[:, :N_PCA], device=w.device)
    rf = g0[None, :] + w @ hinv.T
    g = rf[:, 1:] - rf[:, :-1]
    g = g + torch.clamp(-g.amin(dim=-1, keepdim=True), min=0.0)
    g = g / g.sum(dim=-1, keepdim=True)
    return F.pad(torch.cumsum(g, dim=-1), (1, 0))


def hal_stage(c: Compute, x, p, i, n):
    """hal's encoder stage i: n ReLU 3x3 convs; returns (max_pool 2x2, skip)."""
    for j in range(n):
        x = torch.relu(c.conv(x, p[f"hal.enc{i}.conv{j + 1}.weight"], p[f"hal.enc{i}.conv{j + 1}.bias"]))
    return max_pool_same(x, 2, 2), x


def hal(c: Compute, rgb01, p, training=False):
    """The BGR residual of the hallucinated highlights."""
    with c.scope():
        return _hal(c, vgg_preprocess(rgb01, p["hal.preproc_mean"]), p, training)


def _hal(c: Compute, bgr, p, training):
    x, skips = bgr, []
    for i, (_, n) in enumerate(_HAL_ENC):
        x, s = hal_stage(c, x, p, i + 1, n)
        skips.append(s)
    x = torch.relu(batch_norm(c.conv(x, p["hal.latent_conv.weight"], p["hal.latent_conv.bias"]),
                              p, "hal.latent_bn", training))
    for i in range(len(_HAL_ENC), 0, -1):
        x = torch.relu(c.conv(upsample_x2(x), p[f"hal.dec{i}.conv.weight"], p[f"hal.dec{i}.conv.bias"]))
        x = torch.relu(batch_norm(x, p, f"hal.dec{i}.bn", training))
        x = c.conv(torch.cat([x, skips[i - 1] / 255.0], dim=1), p[f"hal.skip{i}.conv.weight"],
                   p[f"hal.skip{i}.conv.bias"])
    x = torch.relu(batch_norm(c.conv(x, p["hal.head_conv.weight"], p["hal.head_conv.bias"]), p,
                              "hal.head_bn", training))
    return torch.relu(c.conv(torch.cat([x, bgr / 255.0], dim=1), p["hal.skip0.conv.weight"],
                             p["hal.skip0.conv.bias"]))


def pipeline(c: Compute, ldr, p, emor=None, refine_output: bool = True):
    """The serving forward in eval mode: ldr [b, 3, H, W] in [0, 1] -> hdr
    (A_pred itself without the refinement)."""
    c_pred = torch.clamp(deq(c, ldr, p), 0.0, 1.0)
    b_pred = apply_rf(c_pred, lin(c, c_pred, p, emor=emor))
    a_pred = b_pred + highlight_alpha(b_pred) * torch.flip(hal(c, b_pred, p), dims=(1,))
    if not refine_output:
        return a_pred
    return refine(c, torch.cat([a_pred, b_pred, c_pred], dim=1), p)


# ---------------------------------------------------------------- training

def vgg_pools(c: Compute, rgb01, p):
    x = vgg_preprocess(rgb01, torch.tensor(VGG_MEAN_BGR, device=rgb01.device))
    pools = []
    for name, _, _ in _VGG:
        x = torch.relu(c.conv(x, p[f"{name}.weight"], p[f"{name}.bias"]))
        if name in _VGG_POOL_AFTER:
            x = max_pool_same(x, 2, 2)
            pools.append(x)
    return pools


def _per_sample_mean(x):
    return x.mean(dim=(1, 2, 3), keepdim=True)


def joint_loss(c: Compute, p, vgg, batch, emor=None, vgg_compute: Compute = F32, parts=None):
    """The joint objective (joint_training.py): the SUM over the batch of
    deq's L2 + (10 lin L2 + crf MSE) + hal's mu-domain L1 + 1e-3 VGG
    perceptual + 0.1 TV, each sample masked.  The nets in train mode (batch
    statistics); ``batch`` holds ldr, jpeg, clipped_hdr_t, hdr_t, mask,
    invcrf (NCHW).  ``parts``, a dict, receives each net's per-sample term."""
    ldr, jpeg, clipped, hdr_t = batch["ldr"], batch["jpeg"], batch["clipped_hdr_t"], batch["hdr_t"]
    mask, invcrf_gt = batch["mask"], batch["invcrf"]
    c_pred = torch.clamp(deq(c, jpeg, p), 0.0, 1.0)
    loss_deq = _per_sample_mean(torch.square(c_pred - ldr)) * mask
    pred_invcrf = lin(c, ldr, p, training=True, emor=emor)
    b_pred = apply_rf(ldr, pred_invcrf)
    crf_mse = torch.mean(torch.square(pred_invcrf - invcrf_gt), dim=1).reshape(-1, 1, 1, 1)
    loss_lin = (10.0 * _per_sample_mean(torch.square(b_pred - clipped)) + crf_mse) * mask
    a_pred = clipped + highlight_alpha(clipped) * torch.flip(hal(c, clipped, p, training=True), dims=(1,))
    y, t = mu_tonemap(a_pred), mu_tonemap(hdr_t)
    l1 = _per_sample_mean(torch.abs(y - t))
    perc = 0.0
    for fa, fb in zip(vgg_pools(vgg_compute, y, vgg), vgg_pools(vgg_compute, t, vgg)):
        perc = perc + _per_sample_mean(torch.abs(fa - fb))
    n = y.numel()
    tv = (torch.sum(torch.abs(y[:, :, 1:] - y[:, :, :-1])) / n
          + torch.sum(torch.abs(y[:, :, :, 1:] - y[:, :, :, :-1])) / n)
    loss_hal = (l1 + 1e-3 * perc + 0.1 * tv) * mask
    if parts is not None:
        parts.update(deq=loss_deq.detach(), lin=loss_lin.detach(), hal=loss_hal.detach())
    return torch.sum(loss_deq + loss_lin + loss_hal)


class Adam:
    """Adam as Keras configures it (b1 .9, b2 .999, eps 1e-7), torch's rule:
    p -= lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-7):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g)).mul_(self.b1).add_(g, alpha=1 - self.b1)
            v = self.v.setdefault(k, torch.zeros_like(g)).mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = m / (1 - self.b1 ** self.t)
            denom = (v / (1 - self.b2 ** self.t)).sqrt_().add_(self.eps)
            params[k].sub_(self.lr * m_hat / denom)


FROZEN = ("running_mean", "running_var", "preproc_mean")


def train_steps(c: Compute, params: dict, vgg: dict, batches, lr, emor=None):
    """Joint steps from ``params`` (updated in place) on ``batches``: returns
    (each step's per-sample terms {deq, lin, hal: [b]}, the first step's
    gradients)."""
    names = [k for k in params if not k.endswith(FROZEN)]
    opt, terms, first = Adam(lr), [], None
    for batch in batches:
        leaves = dict(params)
        for k in names:
            leaves[k] = params[k].detach().requires_grad_(True)
        parts = {}
        loss = joint_loss(c, leaves, vgg, batch, emor=emor, parts=parts)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        terms.append({k: v.reshape(-1) for k, v in parts.items()})
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
    return terms, first
