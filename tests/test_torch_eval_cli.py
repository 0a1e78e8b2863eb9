"""The port's HDR-Real CLIs on the CPU (counterpart of tests/test_cli.py's
convert -> finetune -> infer -> evaluate chain), each with ``--device cpu``;
evaluate on the JAX package's consolidated npz against the JAX evaluate CLI;
validate_synth from a joint checkpoint; and every new CLI that computes on a
device defaults to the card and raises without one.
"""

import glob
import os

import numpy as np
import pytest
import torch

from singlehdr_tpu import models as jm
from singlehdr_tpu.cli import evaluate as jax_evaluate
from singlehdr_tpu.data.hdr_io import write_hdr
from singlehdr_tpu.train.weight_import import save_variables_npz
from singlehdr_tpu_torch.cli import convert_records, evaluate, finetune, infer, validate_synth
from singlehdr_tpu_torch.cli import serve as cli_serve
from singlehdr_tpu_torch.data.hdr_io import read_hdr
from singlehdr_tpu_torch.data.records import RecordDataset
from singlehdr_tpu_torch.ops import cuda as kernels
from singlehdr_tpu_torch.inference import HdrPredictor
from singlehdr_tpu_torch.train.checkpoint import CheckpointManager
from singlehdr_tpu_torch.train.state import init_multi_state
from singlehdr_tpu_torch.train.steps import make_finetune_train_step

from test_torch_models import seeded_variables
from test_torch_real import write_real_tree


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """One 128x192 pair converted at 64^2 patches: 6 records."""
    root = str(tmp_path_factory.mktemp("real"))
    write_real_tree(root, [(128, 192)], 20)
    out = os.path.join(root, "records")
    n = convert_records.run(convert_records.build_parser().parse_args(
        ["--dir", root, "--out", out, "--patch_size", "64", "--patch_stride", "64"]))
    assert n == 6 and len(RecordDataset(out)) == 6
    hdr, ldr = RecordDataset(out)[0]
    assert hdr.shape == ldr.shape == (64, 64, 3) and ldr.dtype == np.uint8
    return out


@pytest.fixture(scope="module")
def finetuned(records, tmp_path_factory):
    """One finetune epoch through the CLI at batch 2: its checkpoint directory."""
    root = tmp_path_factory.mktemp("finetune")
    cwd = os.getcwd()
    os.chdir(root)  # the CLI writes its run directories under the cwd
    try:
        state = finetune.run(finetune.build_parser().parse_args(
            ["--records", records, "--device", "cpu", "--epochs", "1", "--batch_size", "2",
             "--deq_ckpt", str(root / "ck_deq"), "--lin_ckpt", str(root / "ck_lin"),
             "--hal_ckpt", str(root / "ck_hal"), "--ref_ckpt", str(root / "ck_ref")]))
    finally:
        os.chdir(cwd)
    assert state.step == 3 and state.device.type == "cpu" and set(state.nets) == {
        "deq", "lin", "hal", "ref"}
    assert CheckpointManager(str(root / "ck_ref")).steps() == [3]
    return str(root / "ck_ref")


def _every_slot(ckpt):
    return [a for n in ("deq", "lin", "hal", "ref") for a in (f"--{n}_ckpt", ckpt)]


def test_finetune_cli_checkpoint_holds_all_four_nets(finetuned):
    saved = CheckpointManager(finetuned).load(3)
    assert set(saved["nets"]) == {"deq", "lin", "hal", "ref"} and saved["step"] == 3


@pytest.mark.parametrize("tiled", [False, True])
def test_infer_cli_whole_and_tiled(finetuned, tmp_path, tiled):
    import cv2

    in_dir = tmp_path / "in"
    in_dir.mkdir()
    cv2.imwrite(str(in_dir / "img.jpg"),
                (np.random.RandomState(3).rand(100, 140, 3) * 255).astype(np.uint8))
    argv = ["--dir", str(in_dir), "--output_path", str(tmp_path / "out"), "--device", "cpu",
            *_every_slot(finetuned)]
    if tiled:
        argv += ["--tiled", "--tile", "64", "--halo", "16"]
    kernels.reset_launches()
    (path,) = infer.run(infer.build_parser().parse_args(argv))
    assert glob.glob(str(tmp_path / "out" / "*.hdr")) == [path]
    hdr = read_hdr(path)
    assert hdr.shape == (100, 140, 3) and np.isfinite(hdr).all()
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}  # CPU: plain versions


def test_serve_cli_loads_the_four_checkpoint_slots(finetuned):
    """The serve CLI serves the finetune checkpoint from its four slots, as
    the infer CLI loads it: the same state and the same output."""
    args = cli_serve.build_parser().parse_args(["--device", "cpu", "--warmup", "",
                                                *_every_slot(finetuned)])
    served = cli_serve.make_predictor(args)
    pipe = infer.load_pipeline(infer.build_parser().parse_args(["--device", "cpu",
                                                                *_every_slot(finetuned)]), "cpu")
    saved = CheckpointManager(finetuned).load(3)["nets"]
    got = served.pipeline.state_dict()
    for key, value in pipe.state_dict().items():
        assert torch.equal(got[key], value), key
        net, _, rest = key.partition(".")
        assert torch.equal(value, saved[net][rest]), key
    img = np.random.RandomState(4).rand(64, 96, 3).astype(np.float32)
    np.testing.assert_array_equal(served(img), HdrPredictor(pipe)(img))


def test_finetune_cli_remat_reaches_the_step_factory(records, tmp_path, monkeypatch):
    made = []

    def factory(dtype, remat=False):
        made.append(remat)
        return make_finetune_train_step(dtype, remat=remat)

    monkeypatch.setattr(finetune, "make_finetune_train_step", factory)
    monkeypatch.chdir(tmp_path)
    state = finetune.run(finetune.build_parser().parse_args(
        ["--records", records, "--device", "cpu", "--epochs", "1", "--batch_size", "6", "--remat",
         "--deq_ckpt", str(tmp_path / "ck_deq"), "--lin_ckpt", str(tmp_path / "ck_lin"),
         "--hal_ckpt", str(tmp_path / "ck_hal"), "--ref_ckpt", str(tmp_path / "ck_ref")]))
    assert made == [True] and state.step == 1
    assert CheckpointManager(str(tmp_path / "ck_ref")).steps() == [1]


def test_evaluate_cli_on_the_finetune_checkpoint(records, finetuned):
    out = evaluate.run(evaluate.build_parser().parse_args(
        ["--records", records, "--device", "cpu", "--batch_size", "2", *_every_slot(finetuned)]))
    assert set(out) == {"psnr_linear_db", "psnr_mu_db", "ssim_mu"}
    assert all(np.isfinite(v) for v in out.values()) and -1 <= out["ssim_mu"] <= 1


def test_evaluate_cli_on_a_jax_npz_matches_the_jax_cli(records, tmp_path):
    """The same consolidated npz and records through both CLIs: each metric
    within 1e-3 (dB; SSIM too), which both round to 3 (SSIM 4) decimals.
    Batch 4 over 6 records: the short tail batch is skipped by both."""
    variables = seeded_variables(jm.ReverseCameraPipeline(), (1, 64, 64, 3), seed=21)
    npz = str(tmp_path / "pipeline.npz")
    save_variables_npz(variables, npz)
    argv = ["--records", records, "--weights", npz, "--batch_size", "4"]
    want = jax_evaluate.run(jax_evaluate.build_parser().parse_args(argv))
    got = evaluate.run(evaluate.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3 + 1e-9, (k, got[k], want[k])


def test_validate_synth_cli_from_a_joint_checkpoint(tmp_path):
    rs = np.random.RandomState(22)
    hdr_dir = tmp_path / "hdr"
    hdr_dir.mkdir()
    for i in range(2):
        img = (rs.rand(16, 24, 3).astype(np.float32) * 3) ** 2
        write_hdr(str(hdr_dir / f"s{i}.hdr"), np.kron(img, np.ones((32, 32, 1), np.float32)))
    state = init_multi_state(("deq", "lin", "hal"), 1e-5, seed=3, device="cpu")
    CheckpointManager(str(tmp_path / "jnt")).save(state)
    out = validate_synth.run(validate_synth.build_parser().parse_args(
        ["--hdrdir", str(hdr_dir), "--deq_ckpt", str(tmp_path / "jnt"), "--lin_ckpt",
         str(tmp_path / "jnt"), "--device", "cpu", "--size", "64", "--batches", "2",
         "--batch_size", "2"]))
    assert set(out) == {"deq_psnr", "lin_psnr", "crf_mse"}
    assert all(np.isfinite(v) for v in out.values()) and out["crf_mse"] >= 0


REQUIRED = {
    finetune: ["--records", "r"],
    infer: [],
    evaluate: ["--records", "r"],
    validate_synth: ["--hdrdir", "h"],
}


@pytest.mark.parametrize("cli", list(REQUIRED), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_cli_defaults_to_the_card_and_raises_without_one(cli, monkeypatch):
    """With no --device each CLI runs on the card; without one it raises
    (pass --device cpu) before it reads any input."""
    args = cli.build_parser().parse_args(REQUIRED[cli])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.run(args)
