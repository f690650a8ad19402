#!/usr/bin/env python3
"""One run of one benchmark cell of `srsran_tpu_torch` on NVIDIA GPUs.

    python3 lte_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of `BENCHMARK.json`'s
`workloads`: a configuration (`lte_bench/configs/<config>.json`) under a
traffic mix (`lte_bench/traffic/<mix>.json`).  Set-up draws the TBs from
the seed, renders their subframes with the benchmark's own transmitter,
makes the pool of noisy batches on the card, builds the program's entry
point and warms it.  The window then calls the entry on the pool's batches
in turn, one in flight, and reads each batch's TB bits, CRC flags and
snr_db to the host, for `--seconds`.  After the window a sample of the
batches, drawn from the seed, is judged: every CRC-passing TB against the
sent one, and some batches against the plain reference receiver
(`lte_bench/ref/rx.py`).

`--trace 0` prints the cell's end-to-end metrics; `--trace 1` traces
TRACE_BATCHES batches of the window with `torch.profiler` recording the
device alone, then LABEL_BATCHES more with the host's operations too
(`tracing.py`), and prints the per-layer metrics
(`lte_bench/metrics/<metric>.py`) and a breakdown.  The last line of
standard output is one JSON object; the numbers compared and their limits
are the last lines of standard error and the result's last key.  Exits
non-zero, printing no result, without enough CUDA devices, or when JAX or
the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "lte_bench" / ".cache"
if __name__ == "__main__":
    # the bytecode of every module a run imports, PyTorch's and the
    # program's too, is kept in the checkout, so that only a checkout's
    # first run compiles it, as only its first run builds the MAP kernel
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
from collections import Counter  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "srsran_tpu")
TRACE_FIRST, TRACE_BATCHES, LABEL_BATCHES = 5, 20, 10
SAMPLE_BATCHES = 16
WARM_CALLS = 2


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `srsran_tpu_torch` is not `srsran_tpu`)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             device=None, entry=None) -> tuple[dict, list[str]]:
    """One run.  Returns (the result object, the lines of the numbers
    compared).  `device` None is the cell's `chips` first CUDA devices;
    `entry`, when given, builds what is called in the program's place:
    entry(cfg, link, devices) -> fn(samples) -> results in the link's
    form."""
    import torch

    from lte_bench import catalog, stimuli, tracing

    marks = [("start", T0), ("imports", time.perf_counter())]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w, cfg, mix = catalog.cell(root, workload)
    devices = ([torch.device("cuda", k) for k in range(w["chips"])] if device is None
               else [torch.device(device)])
    dev = devices[0]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
    marks.append(("cuda", time.perf_counter()))
    link = catalog.link(cfg)

    sent = stimuli.draw_tbs(seed, mix["n_tbs"], cfg["grant"]["tbs"])
    clean = torch.from_numpy(stimuli.render(link, cfg, sent)).to(dev)
    marks.append(("render", time.perf_counter()))
    pool = stimuli.build_pool(clean, mix, seed)
    del clean
    idx = stimuli.tb_index(mix)
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(("pool", time.perf_counter()))
    fn = (entry or (lambda c, _l, d: link.build_entry(c, d)))(cfg, link, devices)
    marks.append(("build", time.perf_counter()))
    for i in range(WARM_CALLS):
        out = fn(pool[i % len(pool)])
        [t.cpu() for t in out]
        marks.append((f"warm{i + 1}", time.perf_counter()))

    from srsran_tpu_torch.phy.fec import turbo_cuda

    # the results are read into pinned host buffers made once, as a caller
    # that streams subframes through the card would hold them
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda) for t in out]
    del out
    profile, record = torch.profiler.profile, torch.profiler.record_function
    act = torch.profiler.ProfilerActivity
    # the device alone (on a CPU run, which only the tests make: the host)
    dev_act = [act.CUDA] if cuda else [act.CPU]
    a0, a1 = TRACE_FIRST, TRACE_FIRST + TRACE_BATCHES
    b1 = a1 + LABEL_BATCHES
    rng = np.random.default_rng([seed, 1])
    kept, lat, n_ok, n_bits, launches_per = [], [], 0, 0, []
    gc.collect()
    marks.append(("buffers", time.perf_counter()))
    setup_s = marks[-1][1] - T0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = seen = 0
    while time.perf_counter() < deadline or (trace and i < b1):
        if trace and i == a0:
            prof_a = profile(activities=dev_act)
            prof_a.start()
            launches0 = turbo_cuda.LAUNCHES
            ns_a0 = time.time_ns()
        if trace and i == a1:
            ns_a1 = time.time_ns()
            prof_a.stop()
            launches = turbo_cuda.LAUNCHES - launches0
            prof_b = profile(activities=[act.CPU] + ([act.CUDA] if cuda else []))
            prof_b.start()
            ns_b0 = time.time_ns()
        span = record if trace and a1 <= i < b1 else (lambda _name: nullcontext())
        n_launch = turbo_cuda.LAUNCHES
        t0 = time.perf_counter()
        with span("pool_step"):
            p = i % len(pool)
            x = pool[p]
        with span("entry"):
            out = fn(x)
        with span("result_read"):
            for h, t in zip(host, out):
                h.copy_(t)
        lat.append(time.perf_counter() - t0)
        launches_per.append(turbo_cuda.LAUNCHES - n_launch)
        if trace and i == b1 - 1:
            ns_b1 = time.time_ns()
            prof_b.stop()
        ok_i, bits_i = link.tally(host, cfg)
        n_ok += ok_i
        n_bits += bits_i
        # a uniform sample of the window's batches (reservoir sampling),
        # the traced ones left out so that no copy falls into the trace
        if trace and a0 <= i < b1:
            i += 1
            continue
        j = seen if seen < SAMPLE_BATCHES else int(rng.integers(0, seen + 1))
        seen += 1
        if j < SAMPLE_BATCHES:
            item = (p, tuple(h.clone() for h in host))
            if j < len(kept):
                kept[j] = item
            else:
                kept.append(item)
        i += 1
    window_s = time.perf_counter() - t_start
    batches = i
    found = forbidden_modules()
    if found:
        raise SystemExit(f"lte_bench: loaded after the window: {', '.join(found)}")
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
    del fn, out, x
    if cuda:
        torch.cuda.empty_cache()

    checks = link.judge(kept, pool, idx, sent, cfg)
    limits = cfg["limits"]
    if set(limits) != set(link.CHECKS):
        raise ValueError(f"{cfg['name']}: limits {sorted(limits)} are not the link's {link.CHECKS}")
    correct = batches > 0 and all(checks[k] <= limits[k] for k in limits)
    attempted = batches * mix["batch"]
    result = {"correct": bool(correct), "attempted": attempted, "failed": attempted - n_ok}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": len(devices), "memory_peak_bytes": int(peak)}
    lat_ms = np.asarray(lat) * 1e3
    notes = [f"lte_bench: {workload} seed {seed}: {batches} batches in {window_s:.3f} s, "
             f"batch ms median {np.median(lat_ms):.4f} p95 {np.percentile(lat_ms, 95):.4f} "
             f"(n = {len(lat_ms)}), {n_ok}/{attempted} TBs pass CRC, setup {setup_s:.3f} s",
             "lte_bench: setup s by step: " + " ".join(
                 f"{name} {t - t_prev:.3f}" for (_p, t_prev), (name, t) in zip(marks, marks[1:])),
             "lte_bench: median batch ms by tenth of the window: " + " ".join(
                 f"{np.median(part):.3f}" for part in np.array_split(lat_ms, min(10, len(lat_ms)))),
             "lte_bench: MAP launches per batch: " + ", ".join(
                 f"{k} x{v}" for k, v in sorted(Counter(launches_per).items()))]
    if not trace:
        values = {"tb_mbps": n_bits / window_s / 1e6,
                  "batch_p95_ms": float(np.percentile(lat_ms, 95)), "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in catalog.end_to_end(root, workload)}
    else:
        tr = tracing.reduce(prof_a, TRACE_BATCHES, ns_a0, ns_a1)
        ctx = SimpleNamespace(trace=tr, launches=launches, cfg=cfg, mix=mix, link=link)
        metrics = {}
        for m in catalog.per_layer(root, workload):
            value = catalog.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tracing.idle_gaps(prof_b, ns_b0, ns_b1)}
    result["device"] = device_info
    if cuda:
        result["card"] = power_limit()
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    lines = notes + [f"check {k}: {checks[k]!r} limit {limits[k]!r}" for k in limits]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

    import torch

    from lte_bench import catalog

    w, _cfg, _mix = catalog.cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"lte_bench: {args.workload} needs {w['chips']} CUDA device(s); "
              f"PyTorch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
