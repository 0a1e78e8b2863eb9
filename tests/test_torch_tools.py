"""CPU tests of the port's recipe tools (``singlehdr_tpu_torch/tools``).

- ``quality_anchor.make_dataset`` writes the JAX package's tool's scenes,
  byte for byte;
- ``quality_anchor`` and ``extend_anchor`` issue the JAX tools' stages with
  the JAX tools' arguments (each tool's ``run_stage`` replaced by a recorder,
  the evaluate line faked), the CLI package renamed and ``--device`` added;
- a toy anchor and its extension run through the port's real CLIs on the CPU
  and write finite metrics;
- ``serve_load`` sends exactly ``--requests``, warms every bucket at batch 1
  and at ``--batch`` before its timed window, and builds the pipeline in
  ``--dtype`` (the three faults of the JAX tool);
- ``measure_feed.time_pipeline`` feeds through the codec it is asked for.
"""

import filecmp
import importlib.util
import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

from singlehdr_tpu_torch.tools import extend_anchor, measure_feed, quality_anchor, serve_load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_EVALUATE = '{"psnr_linear_db": 13.5, "psnr_mu_db": 24.5, "ssim_mu": 0.95}\n'
PORTED_CLI, JAX_CLI = "singlehdr_tpu_torch.cli.", "singlehdr_tpu.cli."
DEVICE_STAGES = {"train", "joint_train", "finetune", "evaluate"}


def _jax_tool(name: str, monkeypatch):
    """The JAX package's ``tools/<name>.py``, loaded as ``name`` (its
    ``extend_anchor`` imports ``quality_anchor`` by that name)."""
    monkeypatch.setattr(sys, "path", list(sys.path))  # the tools prepend to it
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setitem(sys.modules, name, module)
    return module


def _files(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_make_dataset_writes_the_jax_tools_scenes(tmp_path, monkeypatch):
    jax_qa = _jax_tool("quality_anchor", monkeypatch)
    jax_dirs = jax_qa.make_dataset(str(tmp_path / "jax"), 2, 2)
    port_dirs = quality_anchor.make_dataset(str(tmp_path / "port"), 2, 2)
    assert [os.path.relpath(d, tmp_path / "jax") for d in jax_dirs] == \
        [os.path.relpath(d, tmp_path / "port") for d in port_dirs]
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port")
    assert files == sorted(["synth/s000.hdr", "synth/s001.hdr", "real/HDR_gt/0.hdr", "real/HDR_gt/1.hdr",
                            "real/LDR_in/0.jpg", "real/LDR_in/1.jpg"])
    for f in files:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f, shallow=False), f


def _placeholder_dataset(workdir, n_train, n_test):
    """make_dataset's directories with empty files: the stage plan links the
    pairs, and no stage runs."""
    synth, real = os.path.join(workdir, "synth"), os.path.join(workdir, "real")
    os.makedirs(synth, exist_ok=True)
    for d, ext in (("HDR_gt", ".hdr"), ("LDR_in", ".jpg")):
        os.makedirs(os.path.join(real, d), exist_ok=True)
        for i in range(n_test):
            open(os.path.join(real, d, f"{i}{ext}"), "w").close()
    return synth, real


def _anchor_workdir(w):
    """What extend_anchor needs of a finished anchor run."""
    for d in ("synth", "records", "ck_jnt", "real_train/HDR_gt", "real_train/LDR_in"):
        os.makedirs(os.path.join(w, d), exist_ok=True)
    for f in ("records/test_00000.shdrec", "records/test_00000.idx", "records/train_00000.shdrec",
              "real_train/HDR_gt/0.hdr", "real_train/LDR_in/0.jpg"):
        open(os.path.join(w, f), "w").close()


def _as_jax(cmd: list) -> list:
    """A port stage command (module, *argv) as the JAX tool would issue it:
    the CLI package renamed and ``--device cpu`` taken out."""
    module, *argv = cmd
    assert module.startswith(PORTED_CLI), module
    stage = module[len(PORTED_CLI):]
    out, i = [JAX_CLI + stage], 0
    while i < len(argv):
        if argv[i] == "--device":
            assert argv[i + 1] == "cpu" and stage in DEVICE_STAGES, cmd
            i += 2
            continue
        out.append(argv[i])
        i += 1
    assert ("--device" in argv) == (stage in DEVICE_STAGES), cmd
    return out


PLAN_CASES = [
    ("quality_anchor", []),
    ("quality_anchor", ["--steps", "7", "--joint_steps", "9", "--finetune_epochs", "3", "--n_train", "5",
                        "--n_test", "7", "--batch", "8", "--dtype", "float32", "--workers", "2",
                        "--ckpt_every", "50"]),
    ("extend_anchor", []),
    ("extend_anchor", ["--joint_iters", "700", "--finetune_epochs", "4", "--ref_name", "ref_more",
                       "--extra_scenes", "2", "--batch", "8", "--dtype", "float32", "--workers", "2",
                       "--note", "more scenes"]),
]


@pytest.mark.parametrize("tool,args", PLAN_CASES)
def test_tools_issue_the_jax_tools_stages(tool, args, tmp_path, monkeypatch):
    jax_qa = _jax_tool("quality_anchor", monkeypatch)
    jax_tool = jax_qa if tool == "quality_anchor" else _jax_tool(tool, monkeypatch)
    port_tool = quality_anchor if tool == "quality_anchor" else extend_anchor
    w = str(tmp_path / "work")
    if tool == "quality_anchor":
        monkeypatch.setattr(jax_qa, "make_dataset", _placeholder_dataset)
        monkeypatch.setattr(quality_anchor, "make_dataset", _placeholder_dataset)
    else:
        _anchor_workdir(w)

    jax_calls, port_calls = [], []

    def jax_run_stage(module, argv, capture=False):
        jax_calls.append([JAX_CLI + module, *argv])  # the JAX run_stage's command
        return types.SimpleNamespace(stdout=FAKE_EVALUATE if module == "evaluate" else "")

    def port_run_stage(module, argv, cwd):
        assert cwd == w
        port_calls.append(quality_anchor.stage_command(module, argv)[2:])
        return quality_anchor.Stage(FAKE_EVALUATE if module == "evaluate" else "", 0.5, [(1, 0.25)])

    monkeypatch.setattr(jax_qa, "run_stage", jax_run_stage)
    monkeypatch.setattr(quality_anchor, "run_stage", port_run_stage)
    monkeypatch.setattr(sys, "argv", [tool, *args, "--workdir", w, "--out", str(tmp_path / "jax.json")])
    jax_tool.main()
    got = port_tool.main([*args, "--workdir", w, "--out", str(tmp_path / "port.json"), "--device", "cpu"])

    assert [_as_jax(c) for c in port_calls] == jax_calls
    assert len(jax_calls) == (8 if tool == "quality_anchor" else 3 + ("--extra_scenes" in args))
    run = "fresh" if tool == "quality_anchor" else "extension"
    assert got["run"] == run and got["device"] == "cpu"
    assert (got["psnr_mu"], got["ssim_mu"], got["psnr_linear"]) == (24.5, 0.95, 13.5)
    with open(tmp_path / "jax.json") as f:
        jax_summary = json.load(f)
    assert set(jax_summary) <= set(got)
    assert {k: got[k] for k in ("steps", "data") if k in jax_summary} == \
        {k: jax_summary[k] for k in ("steps", "data") if k in jax_summary}
    assert all(s == {"wall_s": 0.5, "first_loss": [1, 0.25], "last_loss": [1, 0.25]}
               for s in got["stages"].values())


def test_logged_losses_reads_the_loops_lines():
    out = ("[deq] step 1  loss 0.15000  (1.58s/step)\nnoise\n[deq] step 100  loss 0.00080  (0.05s/step)\n"
           "[ref] epoch 3  loss 0.08123  (12.3s)\n")
    assert quality_anchor.logged_losses(out) == [(1, 0.15), (100, 0.0008), (3, 0.08123)]


@pytest.mark.slow
def test_toy_anchor_and_extension_through_the_clis(tmp_path):
    """The fresh recipe and its extension through the port's real CLIs, one
    stage process each, on the CPU at a toy size."""
    w = str(tmp_path / "anchor")
    fresh = quality_anchor.main(
        ["--workdir", w, "--out", str(tmp_path / "fresh.json"), "--batch", "2", "--steps", "1",
         "--joint_steps", "1", "--finetune_epochs", "1", "--n_train", "2", "--n_test", "5",
         "--workers", "1", "--device", "cpu"])
    ext = extend_anchor.main(
        ["--workdir", w, "--out", str(tmp_path / "ext.json"), "--joint_iters", "1", "--finetune_epochs",
         "1", "--batch", "2", "--workers", "1", "--extra_scenes", "1", "--device", "cpu"])
    for got, run in ((fresh, "fresh"), (ext, "extension")):
        assert got["run"] == run and got["dtype"] == "bfloat16"
        assert all(math.isfinite(got[k]) for k in ("psnr_mu", "ssim_mu", "psnr_linear")), got
        with open(tmp_path / ("fresh.json" if run == "fresh" else "ext.json")) as f:
            assert json.load(f) == got
    trained = ("pretrain_deq", "pretrain_lin", "pretrain_hal", "joint", "finetune")
    assert all(fresh["stages"][s]["last_loss"][0] == 1 for s in trained), fresh["stages"]
    # the joint stage resumes at its last step and takes none
    assert ext["stages"]["joint"]["first_loss"] is None and ext["stages"]["finetune"]["last_loss"]


@pytest.mark.parametrize("requests,clients", [(5, 2), (50, 8), (8, 8), (3, 5)])
def test_client_counts_send_every_request(requests, clients):
    per = serve_load.client_counts(requests, clients)
    assert sum(per) == requests and len(per) == clients and max(per) - min(per) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_load_answers_every_request_from_warm_buckets(dtype, monkeypatch):
    import singlehdr_tpu_torch.models as models

    built = []
    build = models.build_pipeline

    def spy(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(models, "build_pipeline", spy)
    rec = serve_load.main(["--shapes", "64x64,64x96", "--requests", "5", "--clients", "2", "--batch", "2",
                           "--dtype", dtype, "--device", "cpu"])
    assert len(built) == 1 and built[0].dtype == getattr(torch, dtype)
    assert rec["requests"] == rec["answered"] == rec["latency"]["n"] == 5 and rec["errors"] == 0
    assert sum(d["n"] for d in rec["latency_per_bucket"].values()) == 5
    # warm before the timed window: each bucket at batch 1 and at --batch
    assert rec["warm"] == {"64x64": [1, 2], "64x128": [1, 2]}
    assert rec["device_batches"] >= 3 and rec["max_batch"] <= 2
    # CPU tensors take the plain versions: no kernel launches here
    assert not any(n for v in rec["launches"].values() for n in v.values())


@pytest.mark.parametrize("native,producers", [(True, 1), (False, 1), (False, 2)])
def test_time_pipeline_feeds_through_the_codec_asked_for(native, producers, tmp_path, monkeypatch):
    from singlehdr_tpu_torch.data import jpeg, native_jpeg

    if native and not native_jpeg.available():
        pytest.skip("the native codec is not built (make -C native)")
    calls = {"cv2": 0, "native": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jpeg, "_roundtrip_one", counting("cv2", jpeg._roundtrip_one))
    monkeypatch.setattr(native_jpeg, "jpeg_roundtrip_batch_native",
                        counting("native", native_jpeg.jpeg_roundtrip_batch_native))
    available = native_jpeg.available
    synth = measure_feed.write_scenes(str(tmp_path), 2)
    assert sorted(os.listdir(synth)) == ["s000.hdr", "s001.hdr"]
    img_s = measure_feed.time_pipeline(synth, 2, 64, 1, 2, native, producers=producers, device="cpu")
    assert img_s > 0 and np.isfinite(img_s)
    assert native_jpeg.available is available
    if native:
        assert calls["native"] > 0 and calls["cv2"] == 0, calls
    else:
        assert calls["cv2"] > 0 and calls["native"] == 0, calls
