"""GPU smoke run of the PyTorch port: builds the four CUDA kernels, holds each
against its plain PyTorch version at the serving shapes, serves a few requests
through the port's HTTP server at the full published widths, and checks the
served output against the CPU plain path.

  python3 chip_smoke.py          (from the root of a checkout, one CUDA card)

Phases (each prints its own lines; any failure exits non-zero):
  1 device   card name and power limit (nvidia-smi); TF32 off, true f32
  2 build    nvcc build of singlehdr_tpu_torch/csrc into build/kernels/
  3 kernels  K1..K4 vs plain at batch 4, 576x576 (512 + the 32 px pad):
             K1 bit-equal; K2..K4 max|err| / max|plain| <= 1e-4
  4 serving  seeded ReverseCameraPipeline on the card behind make_server;
             4 client threads POST 8 JPEG 512x512 images
  5 parity   one 512x512 image on the card vs the CPU plain path
  6 launches every kernel counted during phase 4, per batch K1 x1, K2 x6,
             K3 x1, K4 x2
  7 timing   p50 latency and img/s at batch 1 and 8, per-net times at batch 8
The second-to-last line is the kernels' JSON record, the last the result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

SERVE_HW = 512
MAX_BATCH = 8
N_REQUESTS = 8
N_CLIENTS = 4
KERNEL_BATCH = 4
KERNEL_REL_TOL = 1e-4   # f32 sum order differs between the kernels and cuDNN
PATH_REL_TOL = 1e-4     # the whole served path vs the CPU plain path (f32 sum order)
SEED = 0

# per batch of the pipeline: launches of each kernel
PER_BATCH = {"apply_rf": 1, "unet_stage2": 6, "lin_feature_stem": 1, "encoder_stage2": 2}
SOURCES = {
    "apply_rf": ("singlehdr_tpu_torch/csrc/apply_rf.cu",
                 "singlehdr_tpu/ops/pallas/apply_rf_pallas.py:159"),
    "unet_stage2": ("singlehdr_tpu_torch/csrc/conv2_pool.cu",
                    "singlehdr_tpu/ops/pallas/unet_stage_pallas.py:263"),
    "lin_feature_stem": ("singlehdr_tpu_torch/csrc/lin_stem.cu",
                         "singlehdr_tpu/ops/pallas/lin_stem_pallas.py:303"),
    "encoder_stage2": ("singlehdr_tpu_torch/csrc/conv2_pool.cu",
                       "singlehdr_tpu/ops/pallas/enc_pool_pallas.py:306"),
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events, warmed)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_cases(pipe, dev):
    """(kernel name, case label, wrapper args) at the main path's shapes, with
    the pipeline's own conv weights; inputs of a later stage are the plain
    outputs of the stage before it.  The seeded init has zero biases, so the
    cases add seeded biases to exercise the kernels' bias path."""
    from singlehdr_tpu_torch.ops import color
    from singlehdr_tpu_torch.ops.curves import monotonic_rf
    from singlehdr_tpu_torch.ops.cuda.enc_pool_cuda import encoder_stage2_plain
    from singlehdr_tpu_torch.ops.cuda.unet_stage_cuda import unet_stage2_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    hw = SERVE_HW + 64
    b = KERNEL_BATCH
    img = torch.rand(b, 3, hw, hw, generator=g, device=dev)
    cases = []

    x = img * 1.4 - 0.2  # includes inputs outside [0, 1]
    raw = torch.rand(b, 1024, generator=g, device=dev)
    cases.append(("apply_rf", f"{tuple(x.shape)}", (x.contiguous(), monotonic_rf(raw).contiguous())))

    def bias(n):
        return (torch.randn(n, generator=g, device=dev) * 0.1).contiguous()

    for net, cin in (("deq", 3), ("ref", 9)):
        unet = getattr(pipe, net).unet
        h = torch.rand(b, cin, hw, hw, generator=g, device=dev)
        stages = [(unet.stem1, unet.stem2, "stem")]
        stages += [(getattr(unet, n).conv1, getattr(unet, n).conv2, n) for n in ("down2", "down3")]
        for c1, c2, label in stages:
            args = (h.contiguous(), c1.weight, bias(c1.bias.numel()), c2.weight,
                    bias(c2.bias.numel()))
            cases.append(("unet_stage2", f"{net}.{label} {tuple(h.shape)}", args))
            h, _ = unet_stage2_plain(*args)

    crf = pipe.lin.crf_feature_net
    scale, shift = crf.stem_bn.folded()
    k7 = (crf.stem.weight * scale[:, None, None, None]).contiguous()
    b7 = (crf.stem.bias * scale + shift + bias(scale.numel())).contiguous()
    cases.append(("lin_feature_stem", f"lin.stem {tuple(img.shape)}", (img, k7, b7)))

    h = color.vgg_preprocess(img, pipe.hal.preproc_mean).contiguous()
    for name in ("enc1", "enc2"):
        enc = getattr(pipe.hal, name)
        args = (h, enc.conv1.weight, bias(enc.conv1.bias.numel()), enc.conv2.weight,
                bias(enc.conv2.bias.numel()))
        cases.append(("encoder_stage2", f"hal.{name} {tuple(h.shape)}", args))
        h, _ = encoder_stage2_plain(*args)
        h = h.contiguous()
    return cases


def check_kernels(pipe, dev) -> dict:
    from singlehdr_tpu_torch.ops.cuda import apply_rf_cuda, enc_pool_cuda, lin_stem_cuda, unet_stage_cuda

    plain = {
        "apply_rf": (apply_rf_cuda.apply_rf, apply_rf_cuda.apply_rf_plain),
        "unet_stage2": (unet_stage_cuda.unet_stage2, unet_stage_cuda.unet_stage2_plain),
        "lin_feature_stem": (lin_stem_cuda.lin_feature_stem, lin_stem_cuda.lin_feature_stem_plain),
        "encoder_stage2": (enc_pool_cuda.encoder_stage2, enc_pool_cuda.encoder_stage2_plain),
    }
    report = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
              for n in plain}
    with torch.inference_mode():
        for name, label, args in kernel_cases(pipe, dev):
            kernel, ref = plain[name]
            got, want = kernel(*args), ref(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, w in zip(got, want):
                if a.shape != w.shape:
                    raise AssertionError(f"{name} {label}: shape {tuple(a.shape)} != {tuple(w.shape)}")
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{name} {label}: non-finite output")
                if not w.abs().max() > 0:
                    raise AssertionError(f"{name} {label}: all-zero reference, nothing compared")
            abs_err = max((a - w).abs().max().item() for a, w in zip(got, want))
            rel_err = max(((a - w).abs().max() / w.abs().max()).item() for a, w in zip(got, want))
            if name == "apply_rf":
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"apply_rf {label}: not bit-equal (max err {abs_err})")
            elif not rel_err <= KERNEL_REL_TOL:
                raise AssertionError(f"{name} {label}: rel err {rel_err:.3e} > {KERNEL_REL_TOL}")
            ms, plain_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: ref(*args))
            r = report[name]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            r["max_rel_err"] = max(r["max_rel_err"], rel_err)
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            print(f"  {name:17s} {label:34s} max_abs_err {abs_err:.3e} rel {rel_err:.3e} "
                  f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms", flush=True)
    torch.cuda.synchronize()
    return report


def jpeg_bodies(n: int) -> list:
    import cv2

    rs = np.random.RandomState(SEED)
    bodies = []
    for _ in range(n):
        img = (rs.rand(SERVE_HW, SERVE_HW, 3) * 255).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", img)
        if not ok:
            raise RuntimeError("JPEG encode failed")
        bodies.append(buf.tobytes())
    return bodies


def decode_hdr(body: bytes) -> np.ndarray:
    import cv2

    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise AssertionError("response is not a decodable Radiance image")
    return img[:, :, ::-1]


def serve_requests(predictor) -> tuple:
    """Phase 4: POST N_REQUESTS JPEGs from N_CLIENTS threads; returns (stats, launches)."""
    from singlehdr_tpu_torch.ops import cuda as kernels
    from singlehdr_tpu_torch.serve import make_server

    server = make_server(predictor, "127.0.0.1", 0, max_batch=MAX_BATCH, batch_window_s=0.05)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    bodies = jpeg_bodies(N_REQUESTS)
    results, errors = [None] * N_REQUESTS, []
    start = threading.Barrier(N_CLIENTS)

    def client(k: int) -> None:
        try:
            start.wait(timeout=60)
            for i in range(k, N_REQUESTS, N_CLIENTS):
                req = urllib.request.Request(url + "/predict", data=bodies[i], method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    results[i] = (r.status, r.read())
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(repr(e))

    try:
        kernels.reset_launches()
        clients = [threading.Thread(target=client, args=(k,)) for k in range(N_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if errors or any(c.is_alive() for c in clients):
        raise AssertionError(f"client failures: {errors}")
    for i, (status, body) in enumerate(results):
        if status != 200:
            raise AssertionError(f"request {i}: HTTP {status}")
        hdr = decode_hdr(body)
        if hdr.shape != (SERVE_HW, SERVE_HW, 3) or not np.isfinite(hdr).all():
            raise AssertionError(f"request {i}: bad HDR {hdr.shape}")
    print(f"  {N_REQUESTS} x HTTP 200, HDR {SERVE_HW}x{SERVE_HW}x3 finite; "
          f"device_batches {stats['device_batches']} max_batch {stats['max_batch']} "
          f"p50 {stats['latency'].get('p50_s')} s", flush=True)
    if stats["max_batch"] < 2:
        raise AssertionError("no request batch larger than 1")
    return stats, launches


def check_launches(stats: dict, launches: dict) -> None:
    batches = stats["device_batches"]
    print(f"  launches {launches} over {batches} device batches", flush=True)
    for name, per in PER_BATCH.items():
        if launches[name] != per * batches:
            raise AssertionError(
                f"{name}: {launches[name]} launches, expected {per} x {batches} batches"
            )


def path_parity(pipe) -> None:
    """Phase 5: the served output of one image on the card vs the CPU plain path."""
    from singlehdr_tpu_torch.inference import HdrPredictor
    from singlehdr_tpu_torch.models import ReverseCameraPipeline

    cpu_pipe = ReverseCameraPipeline()
    cpu_pipe.load_state_dict({k: v.cpu() for k, v in pipe.state_dict().items()})
    img = np.random.RandomState(SEED + 1).rand(SERVE_HW, SERVE_HW, 3).astype(np.float32)
    t0 = time.perf_counter()
    want = HdrPredictor(cpu_pipe.eval())(img)
    cpu_s = time.perf_counter() - t0
    got = HdrPredictor(pipe)(img)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"bad served output {got.shape}")
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"  card vs CPU plain: max_abs_err {np.abs(got - want).max():.3e} "
          f"max|ref| {np.abs(want).max():.4f} rel {rel:.3e} (bound {PATH_REL_TOL}); "
          f"CPU forward {cpu_s:.1f} s", flush=True)
    if not rel <= PATH_REL_TOL:
        raise AssertionError(f"served path differs from the CPU plain path: rel {rel:.3e}")


def timings(predictor, pipe, card: str) -> None:
    rs = np.random.RandomState(SEED + 2)
    imgs = [rs.rand(SERVE_HW, SERVE_HW, 3).astype(np.float32) for _ in range(MAX_BATCH)]
    for n, reps in ((1, 20), (MAX_BATCH, 8)):
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            predictor.predict_batch(imgs[:n])
            lat.append(time.perf_counter() - t0)
        p50 = float(np.median(lat))
        print(f"  b{n} @ {SERVE_HW}^2: p50 {p50 * 1e3:.1f} ms/request batch, "
              f"{n / p50:.2f} img/s  [{card}]", flush=True)
    # per-net device times at batch MAX_BATCH (576^2 after the pad)
    hw = SERVE_HW + 64
    x = torch.rand(MAX_BATCH, 3, hw, hw, device=pipe.deq.unet.stem1.weight.device)
    from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf

    with torch.inference_mode():
        c = pipe.deq(x).clamp(0, 1)
        invcrf = pipe.lin(c)
        bp = apply_rf(c, invcrf)
        abc = torch.cat([bp, bp, c], dim=1)
        nets = {
            "deq": lambda: pipe.deq(x),
            "lin": lambda: pipe.lin(c),
            "apply_rf": lambda: apply_rf(c, invcrf),
            "hal": lambda: pipe.hal(bp),
            "ref": lambda: pipe.ref(abc),
            "pipeline": lambda: pipe(x),
        }
        per_net = {k: cuda_ms(f, 3) for k, f in nets.items()}
    print("  per-net ms at b%d: %s  [%s]" % (
        MAX_BATCH, ", ".join(f"{k} {v:.2f}" for k, v in per_net.items()), card), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    phase("1 device")
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(dev)} x{torch.cuda.device_count()}", flush=True)

    phase("2 build")
    from singlehdr_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.lib()
    print(f"  kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s)",
          flush=True)

    from singlehdr_tpu_torch.inference import HdrPredictor
    from singlehdr_tpu_torch.models import build_pipeline

    pipe = build_pipeline(seed=SEED, device=dev)

    phase("3 kernels vs plain")
    report = check_kernels(pipe, dev)

    phase("4 serving")
    predictor = HdrPredictor(pipe)
    t0 = time.perf_counter()
    predictor.warmup([(SERVE_HW, SERVE_HW)], batch_sizes=(1, MAX_BATCH))
    torch.cuda.synchronize()
    print(f"  warmed {SERVE_HW}x{SERVE_HW} at b1, b{MAX_BATCH} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    stats, launches = serve_requests(predictor)

    phase("5 whole path vs CPU plain")
    path_parity(pipe)

    phase("6 launch counters")
    check_launches(stats, launches)

    phase("7 timings")
    timings(predictor, pipe, card)
    torch.cuda.synchronize()

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in report.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
