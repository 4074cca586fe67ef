"""Times K10 `range_windows` and K20 `segment_hll` of two checkouts of the
port on one card, in turns (other, this, this, other), at chip_smoke.py's
shapes:

* K10 at phase 3c's TQL main path: 17.28 M rows (4000 hosts x 12 h of
  10 s samples, NaN values, NULLs, invalid rows) in two chunks, S_pad 4096,
  W_pad 1024, 721 steps of 60 s; k = 8 over K9's values (5m) and k = 64
  (1h), the row prologue included;
* K20 at phase 9's rows: hll_inputs(hash64(usage_user)) of the TSBS rows
  in (hostname, ts) order, by host at p = 12 and 14, by hour at p = 12,
  and every row on one register (G = 1, m = 4096); beside it the library
  call chip_smoke.py times (`scatter_reduce_` amax over the flat ids);
* with --tql, T3 (`increase(...[1h])`) of phase 6 through `TQL EVAL` on
  the warm tile route, once per checkout: its warm p50 and dispatch stage;
* with --profile, each K10 and K20 shape once more under torch.profiler:
  the device time of each CUDA kernel and memset it launched, per call.

Each turn is a process of its own that imports the port of its checkout
and builds its kernels there (build/ of that checkout).  Each kernel's
time is the mean of --reps calls after one warm-up (CUDA events), and
each output's bytes are hashed, so that the line says whether the two
checkouts gave the same bytes.

Prints the card's name and power limit, one JSON line per turn and shape,
and a last line with the ms of each checkout (mean of its two turns) and
whether every output's bytes agreed.

    python3 tools/kernel_ab.py --other DIR [--hosts 4000] [--hours 12]
                               [--sketch-hours 12] [--reps 20] [--tql] [--profile]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(-1).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _device_us(fn, calls: int = 5) -> dict:
    """{kernel or memset name: device us per call} of fn() under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us and evt.device_type is not None and "cuda" in str(evt.device_type).lower():
            out[evt.key[:60]] = us / calls
    return out


def worker(root: str, hosts: int, hours: int, sketch_hours: int, reps: int, tql: bool,
           prof: bool) -> None:
    sys.path.insert(0, root)
    sys.modules.setdefault("jax", None)
    import torch

    import chip_smoke as c
    from greptimedb_tpu_torch.kernels import build_all
    from greptimedb_tpu_torch.ops import rate as R
    from greptimedb_tpu_torch.ops import sketch as sk

    build_all(("strip_counter_resets", "range_windows", "segment_hll"))
    dev = torch.device("cuda", 0)

    def emit(case, ms, digest, **kw):
        print(json.dumps({"case": case, "ms": ms, "bytes": digest, **kw}), flush=True)

    # K10 at phase 3c's shapes
    n, npad, codes, ts, vals, present, valid = c.prom_planes(hosts, hours, dev)
    s_pad = 1 << (max(hosts, 1) - 1).bit_length()
    steps = hours * 60 + 1
    w_pad = 1 << (steps - 1).bit_length()
    start, end = c.T0, c.T0 + hours * c.H3600

    def source(range_ms):
        return R.RowSource(ts=ts, values=vals, num_series=s_pad, codes=(codes,),
                           radices=(s_pad,), nulls=present, valid=valid,
                           lo=start - range_ms, hi=end + 1)

    adj, _layout = R.strip_counter_resets(source(300_000))
    for range_ms, k, values in ((300_000, 8, adj), (3_600_000, 64, None)):
        src = source(range_ms)
        grid = R.RangeGrid(start, 60_000, range_ms, w_pad, k, s_pad, steps)

        def run():
            return R.range_windows(src, grid, values=values)

        st, pres = run()
        emit(f"K10 k={k}", c._timed(run, reps), _digest(st.tensors() + (pres,)),
             **({"device_us": _device_us(run)} if prof else {}))
        del st, pres
    del codes, ts, vals, present, valid, adj
    torch.cuda.empty_cache()

    # K20 at phase 9's rows
    import numpy as np
    import pyarrow as pa

    user = c.tsbs_columns(c.Tsbs(hosts, sketch_hours), ("usage_user",))["usage_user"]
    rows = user.shape[0]
    ticks = rows // hosts
    hashes = sk.hash64(pa.array(user))

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    host = up(np.repeat(np.arange(hosts, dtype=np.int32), ticks))
    hour = up(np.tile((np.arange(ticks) * c.SCRAPE_S // 3600).astype(np.int32), hosts))
    inputs = {p: [up(x) for x in sk.hll_inputs(hashes, p)] for p in (12, 14)}
    zeros = torch.zeros(rows, dtype=torch.int32, device=dev)
    cases = {
        "K20 host p=12": (*inputs[12], host, hosts, 1 << 12),
        "K20 hour p=12": (*inputs[12], hour, sketch_hours, 1 << 12),
        "K20 host p=14": (*inputs[14], host, hosts, 1 << 14),
        "K20 one register": (zeros, inputs[12][1], zeros, 1, 1 << 12),
    }
    for name, args in cases.items():
        got = sk.segment_hll(*args)
        emit(name, c._timed(lambda: sk.segment_hll(*args), reps), _digest([got]),
             library_ms=c._timed(c._library_call("hll", args, dev), reps), rows=rows,
             **({"device_us": _device_us(lambda: sk.segment_hll(*args))} if prof else {}))
        del got
        torch.cuda.empty_cache()

    if tql:
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as home:
            out = c.run_tql_slice("cuda", hosts, hours, 3, home)
        t3 = out["queries"]["T3"]
        emit("T3 tile warm", t3["warm_p50_ms"], None,
             dispatch_ms=t3["warm_stage_p50_ms"].get("dispatch"),
             stage_ms=t3["warm_stage_p50_ms"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout (the root of its tree)")
    ap.add_argument("--hosts", type=int, default=4000)
    ap.add_argument("--hours", type=int, default=12)
    ap.add_argument("--sketch-hours", type=int, default=12)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tql", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.hosts, args.hours, args.sketch_hours, args.reps, args.tql,
               args.profile)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    other = os.path.abspath(args.other)
    turns = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    ms: dict[str, dict[str, list]] = {}
    digests: dict[str, set] = {}
    for i, (label, root) in enumerate(turns):
        # T3 once per checkout: the TQL slice ingests 34.56 M rows
        tql = args.tql and i in (1, 3)
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root,
               "--hosts", str(args.hosts), "--hours", str(args.hours),
               "--sketch-hours", str(args.sketch_hours), "--reps", str(args.reps)]
        cmd += ["--profile"] if args.profile else []
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + (["--tql"] if tql else []), capture_output=True, text=True,
                              cwd=root)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if not line.startswith('{"case"'):
                continue
            rec = json.loads(line)
            print(json.dumps({"turn": i, "tree": label, **rec}), flush=True)
            ms.setdefault(rec["case"], {}).setdefault(label, []).append(rec["ms"])
            if rec["bytes"] is not None:
                digests.setdefault(rec["case"], set()).add(rec["bytes"])
        print(json.dumps({"turn": i, "tree": label, "seconds": time.perf_counter() - t0}),
              flush=True)
    print(json.dumps({
        "ms": {case: {label: sum(v) / len(v) for label, v in per.items()}
               for case, per in ms.items()},
        "same_bytes": all(len(d) == 1 for d in digests.values()),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
