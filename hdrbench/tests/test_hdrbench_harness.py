"""The harness's own arithmetic and rules, on the CPU."""

from __future__ import annotations

import ast
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hdrbench.harness import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "singlehdr_tpu"}


def _imports(path: str) -> set:
    """Top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = ""):
    for root, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_anywhere_and_a_reference_of_its_own():
    """Top-level names compared whole: ``singlehdr_tpu_torch`` is not
    ``singlehdr_tpu``; the reference imports nothing of the program."""
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path
    for path in _sources("reference"):
        assert "singlehdr_tpu_torch" not in _imports(path), path
    assert "singlehdr_tpu_torch".split(".")[0] not in FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole cell, shrunk, in a fresh process: no JAX module is loaded
    after the window (the harness's own check, and this test's)."""
    code = ("import sys, json; from hdrbench.tests.tiny import run_tiny; "
            "c, line, _ = run_tiny('batch-f32-512'); "
            "print(json.dumps([c, sorted({m.split('.')[0] for m in sys.modules} & set("
            f"{sorted(FORBIDDEN)!r}))]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    rc, found = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0 and found == [], out.stderr[-2000:]


def test_p95_counts_failures_above_every_latency():
    from hdrbench.drivers.serve import p95

    lat = [0.1 * i for i in range(1, 101)]
    assert p95(lat) == pytest.approx(9.5)
    assert p95(lat[:95] + [None] * 5) == pytest.approx(9.5)
    assert math.isinf(p95(lat[:94] + [None] * 6))


def test_busy_union_and_gaps():
    from hdrbench.trace import busy_us, summarize

    assert busy_us([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 12, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "feed", "ts": 16, "dur": 12},
    ]}
    s = summarize(trace)
    assert s["busy_s"] == pytest.approx(25e-6) and s["window_s"] == pytest.approx(42e-6)
    assert dict(s["breakdown"]["idle_gaps"]) == pytest.approx({"feed": 15e-6, "aten::copy_": 2e-6})
    assert s["breakdown"]["device_ops"][0] == ["k1", pytest.approx(10e-6)]


def test_flop_count_of_one_conv_by_hand():
    from hdrbench.reference import flops as FL
    from hdrbench.reference import nets as R

    b, cin, cout, k, h, w = 2, 16, 32, 5, 40, 24
    wt = torch.empty(cout, cin, k, k, device="meta")
    got = FL.count(lambda x: R.conv_same(x, wt), torch.empty(b, cin, h, w, device="meta"))
    assert got == 2 * b * cout * h * w * cin * k * k
    # a K2 stage: two such convs, and bytes of x, weights, biases, act and pool
    flops, byts = FL._conv_pair(cin, cout, k, b, h, w, (h // 2, w // 2))
    assert flops == 2 * b * cout * h * w * k * k * (cin + cout)
    assert byts == 4 * (b * cin * h * w + cout * cin * k * k + cout * cout * k * k + 2 * cout
                        + b * cout * h * w + b * cout * (h // 2) * (w // 2))


def test_reference_matches_the_port_on_the_cpu():
    """The serving forward and one f32 joint step, the program against the
    reference from the same seeded weights, at a tiny size."""
    from hdrbench import scenes, system
    from hdrbench.drivers.train import ARGS, leaf_gaps
    from hdrbench.harness import Cell
    from hdrbench.reference import capture
    from hdrbench.reference import nets as R
    from singlehdr_tpu_torch.train.steps import make_joint_train_step

    torch.set_num_threads(4)
    cpu = torch.device("cpu")
    cfg = {"nets": ["deq", "lin", "hal", "ref"], "compute_dtype": "float32", "use_refinement": True,
           "bucket_multiple": 64}
    cell = Cell("t", cfg, {}, 1, 11, 1.0, False, 0.0, cpu)
    w = system.weights(cell)
    g = torch.Generator().manual_seed(1)
    ldr = torch.from_numpy(scenes.ldr_images(g, 2, 64, 96, cpu)).permute(0, 3, 1, 2).float() / 255
    with torch.inference_mode():
        got = system.pipeline(cell, w)(ldr).hdr
        want = R.pipeline(R.F32, ldr, w)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5

    cfg = {"nets": ["deq", "lin", "hal"], "compute_dtype": "float32", "learning_rate": 1e-5}
    cell = Cell("t", cfg, {}, 1, 12, 1.0, False, 0.0, cpu)
    w, vw = system.weights(cell), system.vgg_weights(cell)
    state = system.train_state(cell, w)
    step = make_joint_train_step(system.vgg(cell, vw), torch.float32)
    hdr = scenes.hdr_scenes(g, 4, 64, 64, cpu) * 0.3
    inv = torch.rand(4, 1024, generator=g).sort(dim=1).values
    batch = capture.feed_batch(hdr, inv, inv)
    out = step(state, *(batch[k] for k in ARGS))
    first = {k: state.optimizer.state[p]["exp_avg"] / 0.1 for k, p in state.nets.named_parameters()}
    params = {k: v.clone() for k, v in w.items()}
    terms, ref_first = R.train_steps(R.F32, params, vw, [batch], 1e-5)
    ref_loss = float(sum(v.sum() for v in terms[0].values()))
    assert float(out.loss) == pytest.approx(ref_loss, rel=1e-5)
    assert leaf_gaps(first, ref_first, list(ref_first))[0][0] < 1e-4
    after = {k: p.detach() for k, p in state.nets.named_parameters()}
    moved = list(ref_first)
    assert leaf_gaps({k: after[k] - w[k] for k in moved}, {k: params[k] - w[k] for k in moved},
                     moved)[0][0] < 1e-2


def test_open_loop_schedule_is_the_seeds_and_the_same_work_for_every_seed():
    from hdrbench.drivers.serve import schedule
    from hdrbench.harness import Cell, load_json

    t = load_json(BENCH_DIR, "traffic", "serve-mixed.json")
    cell = lambda seed: Cell("s", {}, t, 1, seed, 30.0, False, 0.0)  # noqa: E731
    a, wa = schedule(cell(2**31 + 3), t["pool_per_size"])
    b, wb = schedule(cell(2**31 + 3), t["pool_per_size"])
    c, _ = schedule(cell(5), t["pool_per_size"])
    assert a == b and wa == wb
    assert a != c
    assert len(a) == len(c) == round(t["rate_rps"] * (t["lead_s"] + 30.0))
    assert sorted(s for _, s, _ in a) == sorted(s for _, s, _ in c)
    gaps = lambda p: np.sort(np.diff([0.0] + [d for d, _, _ in p]))  # noqa: E731
    assert np.allclose(gaps(a), gaps(c))
    assert a[-1][0] == pytest.approx(t["lead_s"] + 30.0)


def test_a_config_a_mix_and_a_metric_added_as_files_alone(tmp_path):
    """In a copy of the checkout, a new configuration, traffic mix and
    per-layer metric are added as new files and entries of BENCHMARK.json,
    no file edited, and a tiny cell of them runs on the CPU."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "hdrbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(ROOT, "singlehdr_tpu_torch"), root / "singlehdr_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(BENCH_DIR, "configs", "hdr4-f32.json")))
    cfg.update(name="hdr3-f32-noref", use_refinement=False)
    (root / "hdrbench" / "configs" / "hdr3-f32-noref.json").write_text(json.dumps(cfg))
    mix = json.load(open(os.path.join(BENCH_DIR, "traffic", "batch32-512.json")))
    mix.update(batch=2, height=64, width=128, check_images=2, check_batches=1, pool_img_s=4)
    (root / "hdrbench" / "traffic" / "batch2-64x128.json").write_text(json.dumps(mix))
    (root / "hdrbench" / "metrics" / "batches.count.py").write_text(
        "def read(out):\n    return out.counters.get('batches')\n")
    bench["configs"].append({"name": "hdr3-f32-noref", "source": "https://arxiv.org/abs/2004.01179",
                             "file": "hdrbench/configs/hdr3-f32-noref.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny", "config": "hdr3-f32-noref", "traffic": "batch2-64x128",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tiny")
    bench["per_layer"].append({"name": "batches.count", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "predictor (inference.py)",
                               "moves": "infer_img_s", "workloads": ["tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, torch; torch.set_num_threads(4); from hdrbench.run import execute; "
            "c, line, _ = execute('tiny', 3, 1.0, True, torch.device('cpu')); print(json.dumps(line))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], out.stderr[-3000:]
    assert line["metrics"]["batches.count"]["value"] >= 1
