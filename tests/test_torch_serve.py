"""The PyTorch port's inference and serving surface on the CPU.

``HdrPredictor`` is held to the JAX package's predictor with one set of
weights (bridged by ``convert``) on a 50x70 image, which takes the bicubic
resize path (bucket 64x128, padded 128x192).  The HTTP server is driven over
a socket like ``tests/test_serve.py`` drives the JAX one.
"""

import concurrent.futures
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from singlehdr_tpu import models as jm
from singlehdr_tpu.data import hdr_io
from singlehdr_tpu.inference import HdrPredictor as JaxHdrPredictor
from singlehdr_tpu_torch import models as tm
from singlehdr_tpu_torch.cli import infer as cli_infer
from singlehdr_tpu_torch.cli import serve as cli_serve
from singlehdr_tpu_torch.convert import load_jax_variables
from singlehdr_tpu_torch.inference import HdrPredictor, crop_back, pad_to_multiple
from singlehdr_tpu_torch.ops import cuda as kernels
from singlehdr_tpu_torch.serve import make_server
from test_torch_models import seeded_variables

ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_predictor_matches_jax_on_the_bicubic_path():
    variables = seeded_variables(jm.ReverseCameraPipeline(), (1, 64, 64, 3), seed=5)
    img = np.random.RandomState(2).rand(50, 70, 3).astype(np.float32)
    want = JaxHdrPredictor(variables)(img)
    pipe = load_jax_variables(tm.ReverseCameraPipeline(), variables)
    predictor = HdrPredictor(pipe)
    got = predictor(img)
    assert predictor.bucket_key(img.shape) == (64, 128)
    assert got.shape == want.shape == (50, 70, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_pad_crop_roundtrip():
    img = np.random.RandomState(0).rand(100, 130, 3).astype(np.float32)
    padded, hw = pad_to_multiple(img, 64)
    assert padded.shape[:2] == (128, 192)
    np.testing.assert_array_equal(crop_back(padded, hw), img)


def test_serve_cli_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """With no --device the CLI serves on the card; without one it raises
    (pass --device cpu) instead of serving on the CPU."""
    args = cli_serve.build_parser().parse_args(["--warmup", ""])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_serve.run(args)


@pytest.fixture(scope="module")
def server():
    predictor = HdrPredictor(cli_infer.load_weights(None, "cpu"))
    predictor.warmup([(64, 64)], batch_sizes=(1, 4))
    srv = make_server(predictor, "127.0.0.1", 0, max_batch=4, batch_window_s=0.05)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", predictor
    srv.shutdown()
    thread.join(timeout=10)


def _jpeg_bytes(rng, h, w):
    import cv2

    ok, buf = cv2.imencode(".jpg", (rng.rand(h, w, 3) * 255).astype(np.uint8))
    assert ok
    return buf.tobytes()


def _post(url, body):
    req = urllib.request.Request(url + "/predict", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


def test_server_answers_predict_healthz_and_stats(server, tmp_path):
    url, _ = server
    kernels.reset_launches()
    status, body = _post(url, _jpeg_bytes(np.random.RandomState(0), 64, 80))
    assert status == 200
    path = tmp_path / "out.hdr"
    path.write_bytes(body)
    hdr = hdr_io.read_hdr(str(path))
    assert hdr.shape == (64, 80, 3) and np.isfinite(hdr).all()
    with urllib.request.urlopen(url + "/healthz") as r:
        assert r.read() == b"ok"
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(
            urllib.request.Request(url + "/predict", data=b"not an image", method="POST"),
            timeout=60,
        )
    assert exc.value.code == 400
    with urllib.request.urlopen(url + "/stats") as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 2 and stats["errors"] >= 1
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}


def test_server_micro_batches_concurrent_requests(server):
    url, predictor = server
    body = _jpeg_bytes(np.random.RandomState(1), 64, 64)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda _: _post(url, body), range(4)))
    assert [s for s, _ in results] == [200] * 4
    with urllib.request.urlopen(url + "/stats") as r:
        stats = json.loads(r.read())
    assert stats["max_batch"] > 1
    # groups pad up to a warm size: nothing but the warmed sizes ran
    assert predictor._warm[(64, 64)] == {1, 4}


def test_serve_trace_busy_time_is_the_union_of_device_intervals():
    """tools/serve_trace's reading of an exported trace: busy time is the
    union of overlapping kernel/memcpy intervals, idle share the rest of the
    span, and kernels are grouped by kind."""
    from singlehdr_tpu_torch.tools import serve_trace as st

    assert st.busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    trace = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "lin_stem_kernel", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm", "ts": 30, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 70, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]}
    got = st.summarize(trace, steps=2)
    assert got["span_ms"] == pytest.approx(0.05)
    assert got["busy_ms"] == pytest.approx(0.025)
    assert got["idle_share"] == pytest.approx(0.5)
    assert got["by_kind_ms"] == pytest.approx({"hand K3": 0.015, "cuDNN convs": 0.01,
                                               "H2D / D2H / memset": 0.005})



@pytest.mark.parametrize("name", ["void (anonymous namespace)::conv_gemm_kernel<3, 64, (Mode)3>",
                                  "void (anonymous namespace)::conv_gemm_bf16_kernel<3, 64, "
                                  "(Mode)3, 2>"])
def test_serve_trace_counts_both_conv_kernels_as_hand_k2_k4(name):
    """The f32 and the bf16 conv kernel of K2/K4 are the hand kernels, not
    cuDNN's convs (whose names also hold "conv")."""
    from singlehdr_tpu_torch.tools import serve_trace as st

    assert st.kind(name, "kernel") == "hand K2 + K4"
