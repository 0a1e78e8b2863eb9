"""lin's pretraining, the JAX package's and the port's, in lockstep on the CPU.

The quality anchor's lin stage (``cli.train --lin true``, 900 steps, b16 @
256², Adam at 1e-4) sits near a loss of 0.45 and leaves it at a step that
differs from run to run.  ``lockstep`` runs JAX's lin pretraining step and
the port's from one start, the JAX CLI's initialisation with
``PRNGKey(seed)`` bridged into the port, on the same batches of the port's
HDR-Synth feed (seeded with ``seed``, no JPEG, as the anchor's lin stage),
over the anchor's procedural scenes, and logs both losses as the training
loops log them: step 1, then the mean over each window of ``log_every``
steps.  Run as a script it does so for several seeds and writes one JSON
record:

    python tests/test_torch_lin_plateau.py --seeds 0,1,2 --steps 900 \\
        --batch 16 --patch 128 --scenes 64 --out build/dev/lin_plateau.json

The test runs three steps at a small size: on the feed's real batches the
two packages' losses agree as the one-step parity of
``test_torch_train.py`` holds them.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

if __name__ == "__main__":  # the tests' CPU pin, before JAX starts
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from singlehdr_tpu.models import LinearizationNet as JaxLinearizationNet
from singlehdr_tpu.train import steps as jsteps
from singlehdr_tpu.train.state import init_net_state as jax_init_net_state
from singlehdr_tpu_torch.convert import load_jax_variables
from singlehdr_tpu_torch.data.synth import get_train_dataset
from singlehdr_tpu_torch.models import LinearizationNet
from singlehdr_tpu_torch.tools.quality_anchor import make_dataset
from singlehdr_tpu_torch.train import steps
from singlehdr_tpu_torch.train.loop import LoopConfig, SynthBatchPipeline
from singlehdr_tpu_torch.train.state import TrainState, make_optimizer

LR = 1e-4  # the anchor's pretraining rate (cli.train's default)
KEYS = ("ldr", "clipped_hdr_t", "mask", "invcrf")


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).contiguous().numpy() if t.ndim == 4 and t.shape[1] == 3 \
        else t.numpy()


def lockstep(synth_dir: str, seed: int, n_steps: int, batch: int, patch: int,
             log_every: int = 100, workers: int = 2, echo: bool = False) -> dict:
    """{"jax": [(step, loss)], "port": [(step, loss)], "s": seconds}: step 1's
    loss, then each window's mean, for both packages from one start."""
    jstate = jax_init_net_state(JaxLinearizationNet(), jax.random.PRNGKey(seed),
                                jnp.zeros((1, 64, 64, 3), jnp.float32), LR)
    nets = torch.nn.ModuleDict({"lin": LinearizationNet()})
    load_jax_variables(nets["lin"], {"params": jstate.params, "batch_stats": jstate.batch_stats})
    pstate = TrainState(nets, make_optimizer(nets.parameters(), LR))
    jstep, pstep = jsteps.make_lin_train_step(), steps.make_lin_train_step()
    feed = SynthBatchPipeline(get_train_dataset(synth_dir, patch_size=patch),
                              LoopConfig(batch_size=batch, n_workers=workers, seed=seed, use_jpeg=False),
                              torch.device("cpu"))
    logged = {"jax": [], "port": []}
    window = {"jax": [], "port": []}
    t0 = time.perf_counter()
    try:
        for step in range(1, n_steps + 1):
            b = feed.next_batch()
            jstate, jloss, _ = jstep(jstate, *[jnp.asarray(_nhwc(b[k])) for k in KEYS])
            ploss, _ = pstep(pstate, *[b[k] for k in KEYS])
            for name, loss in (("jax", float(jloss)), ("port", float(ploss))):
                window[name].append(loss)
                if step % log_every == 0 or step == 1:
                    logged[name].append((step, float(np.mean(window[name]))))
                    window[name] = []
            if echo and (step % log_every == 0 or step == 1):
                print(f"seed {seed} step {step}: jax {logged['jax'][-1][1]:.5f} port "
                      f"{logged['port'][-1][1]:.5f} ({time.perf_counter() - t0:.0f} s)", flush=True)
    finally:
        feed.close()
    return {**logged, "s": time.perf_counter() - t0}


def test_lin_pretraining_steps_match_jax_on_the_feeds_batches(tmp_path):
    torch.manual_seed(0)
    synth, _ = make_dataset(str(tmp_path), 2, 0)  # every 20th scene is held out, the first of them
    run = lockstep(synth, seed=0, n_steps=3, batch=2, patch=64, log_every=1, workers=1)
    jax_losses = [loss for _, loss in run["jax"]]
    port_losses = [loss for _, loss in run["port"]]
    assert len(jax_losses) == len(port_losses) == 3
    assert all(np.isfinite(jax_losses + port_losses))
    # test_torch_train's one-step bound on the loss, held over three steps
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--steps", type=int, default=900)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--patch", type=int, default=128)
    p.add_argument("--scenes", type=int, default=64, help="the anchor's --n_train")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--workdir", default="build/dev/lin_plateau")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    synth, _ = make_dataset(args.workdir, args.scenes, 0)
    record = {"steps": args.steps, "batch": args.batch, "patch": args.patch, "scenes": args.scenes,
              "lr": LR, "runs": {}}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = lockstep(synth, seed, args.steps, args.batch, args.patch, args.log_every, echo=True)
        record["runs"][seed] = run
        print(json.dumps({"seed": seed, **run}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f)
    return record


if __name__ == "__main__":
    main()
