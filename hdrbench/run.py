"""Run one cell of the benchmark once and print its result line.

  python3 -m hdrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (its file under ``hdrbench/configs/``) and a traffic
mix (``hdrbench/traffic/<mix>.json``), whose ``driver`` is the module under
``hdrbench/drivers/`` that runs it.  With ``--trace 0`` the line carries the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, each
read by ``hdrbench/metrics/<metric>.py`` from the run's spans, counters and
device trace (a reader that finds nothing leaves its metric out).

Exits 2, printing no result, without a CUDA card or with fewer cards than
the cell asks for; exits 3 if JAX or the JAX package is loaded when the
window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from hdrbench.harness import BENCH_DIR, ROOT, Cell, Outcome, load_json, note  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "singlehdr_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``singlehdr_tpu_torch`` is not ``singlehdr_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)


def resolve(bench: dict, workload: str):
    """(cell entry, configuration, traffic) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    entry = cells[workload]
    (cfg,) = [c for c in bench["configs"] if c["name"] == entry["config"]]
    return entry, load_json(ROOT, cfg["file"]), load_json(BENCH_DIR, "traffic", f"{entry['traffic']}.json")


def applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(f"hdrbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def result_line(bench: dict, cell: Cell, out: Outcome, device_info: dict) -> dict:
    e2e = {m["name"] for m in bench["end_to_end"] if applies(m, cell.name, set())}
    metrics = {}
    if cell.trace:
        for m in bench["per_layer"]:
            if applies(m, cell.name, e2e):
                read = reader(m["name"])
                value = read(out) if read else None
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(out.metrics[m["name"]]), "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=int(out.memory_peak_bytes))
    line = {"correct": out.correct, "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if cell.trace and out.trace:
        device.update(busy_s=out.trace["busy_s"], window_s=out.trace["window_s"])
        line["breakdown"] = out.trace["breakdown"]
    line["checks"] = {n: {"value": float(v), "limit": float(lim)} for n, v, lim in out.checks}
    return line


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            traffic_overrides: dict | None = None, config_overrides: dict | None = None) -> tuple:
    """Run ``workload`` on ``device``; (exit code, result line, outcome).
    The overrides shrink a cell for the CPU tests."""
    bench = load_json(ROOT, "BENCHMARK.json")
    entry, config, traffic = resolve(bench, workload)
    traffic.update(traffic_overrides or {})
    config.update(config_overrides or {})
    cell = Cell(name=workload, config=config, traffic=traffic, chips=entry["chips"], seed=seed,
                seconds=seconds, trace=trace, t0=T0, device=device,
                limits=traffic.get("limits", {}))
    driver = importlib.import_module(f"hdrbench.drivers.{traffic['driver']}")
    out = driver.run(cell)
    found = loaded_forbidden()
    if found:
        note(f"loaded after the window: {', '.join(found)}; no result")
        return 3, None, out
    import torch

    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": entry["chips"]}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    for line in out.notes:
        note(line)
    line = result_line(bench, cell, out, info)
    for name, c in line["checks"].items():
        note(f"check {name} = {c['value']!r} (limit {c['limit']!r}): "
             f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    return 0, line, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    bench = load_json(ROOT, "BENCHMARK.json")
    entry, _, _ = resolve(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        note(f"{args.workload} needs {entry['chips']} CUDA card(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    code, line, _ = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0))
    if line is not None:
        print(json.dumps(line), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
