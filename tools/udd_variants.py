"""Times design variants of K21 `segment_udd` (csrc/segment_udd.cu, its
ordered path on csrc/group_runs.cuh) on the card, at phase 9's rows: the
TSBS rows of 4000 hosts x --sketch-hours (10 s scrapes, in (hostname, ts)
order), usage_user's UDDSketch buckets (gamma of 1 %), one row in 100
masked, by host at B = 128 and 1024 (and at B = 1024 on the first of the
two-step path's shards), by hour at B = 1024 (the atomic path), and every
row on one bucket.

A variant is a copy of csrc/ with constants rewritten, built by
tools/radix_variants.py's `build_variants` into build/udd_variants/:
OWNER_VARIANTS edit segment_udd.cu (kOwnRows, the rows in flight a lane;
kOwnThreads, with kOwnMinCtas, the owner CTAs an SM its registers allow),
RUN_VARIANTS edit group_runs.cuh (kRunRows, the run pass's rows in flight
a lane; kRunCtasPerSm, its grid cap).  The committed kernel's
outputs are held byte for byte against the plain version, and each
variant's against the committed kernel's, before they are timed: CUDA
events (the median of five means of --reps calls) and each kernel's device
µs a call from torch.profiler.  `nvcc --resource-usage` of each variant is
printed first.

Prints the card's name and power limit, then one JSON line per variant and
shape.

    python3 tools/udd_variants.py [--reps 20] [--sketch-hours 6]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from kernel_ab import _device_us  # noqa: E402
from radix_variants import build_variants, use_libraries  # noqa: E402

SOURCE = "segment_udd"
# name -> {constant of segment_udd.cu: value}
OWNER_VARIANTS = {
    "owners: 8 rows a lane": {"kOwnRows": 8},
    "owners: 64 threads": {"kOwnThreads": 64},
    "owners: 256 threads": {"kOwnThreads": 256, "kOwnMinCtas": 6},
    "owners: 512 threads": {"kOwnThreads": 512, "kOwnMinCtas": 3},
}
# name -> {constant of group_runs.cuh: value}
RUN_VARIANTS = {
    "run pass: 4 rows a lane": {"kRunRows": 4},
    "run pass: 16 rows a lane": {"kRunRows": 16},
    "run pass: 8 CTAs an SM": {"kRunCtasPerSm": 8},
}


def shapes(hosts: int, hours: int, dev) -> dict:
    """shape -> segment_udd arguments."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from greptimedb_tpu_torch.ops import sketch as sk

    user = cs.tsbs_columns(cs.Tsbs(hosts, hours), ("usage_user",))["usage_user"]
    rows = user.shape[0]
    ticks = rows // hosts

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    host = up(np.repeat(np.arange(hosts, dtype=np.int32), ticks))
    hour = up(np.tile((np.arange(ticks) * cs.SCRAPE_S // 3600).astype(np.int32), hosts))
    mask_np = np.ones(rows, dtype=bool)
    mask_np[::100] = False
    mask = up(mask_np)
    bid = {b: up(sk.udd_bucket_ids(user, cs.UDD_GAMMA, b)) for b in (128, 1024)}
    shard = (hosts // cs.SHARDS) * ticks  # the two-step path's first shard
    return {
        "host B=1024, one shard": (bid[1024][:shard], host[:shard], mask[:shard], hosts, 1024),
        "host B=128": (bid[128], host, mask, hosts, 128),
        "host B=1024": (bid[1024], host, mask, hosts, 1024),
        "hour B=1024": (bid[1024], hour, mask, hours, 1024),
        "one bucket": (torch.zeros(rows, dtype=torch.int32, device=dev),
                       torch.zeros(rows, dtype=torch.int32, device=dev),
                       torch.ones(rows, dtype=torch.bool, device=dev), 1, 128),
    }


def measure(name: str, cases: dict, want: dict, reps: int) -> None:
    import chip_smoke as cs
    from greptimedb_tpu_torch.ops import sketch as sk

    for shape, args in cases.items():
        call = lambda args=args: sk.segment_udd(*args)  # noqa: E731
        cs._compare_bytes(call(), want[shape], f"{name} {shape}")
        us, _count = _device_us(call)
        print(json.dumps({"variant": name, "shape": shape, "path": sk.last_udd_path(),
                          **cs._timed_runs(call, reps), "device_us": us,
                          "device_sum_us": sum(us.values())}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sketch-hours", type=int, default=6)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("udd_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.modules.setdefault("jax", None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = os.path.join(ROOT, "build", "udd_variants")
    libs = build_variants(os.path.join(out, "owner"), OWNER_VARIANTS, f"{SOURCE}.cu", (SOURCE,))
    libs.update(build_variants(os.path.join(out, "run"), RUN_VARIANTS, "group_runs.cuh",
                               (SOURCE,)))
    for name, built in libs.items():
        print(json.dumps({"variant": name, "resource_usage": built[SOURCE][1]}), flush=True)
    import chip_smoke as cs
    from greptimedb_tpu_torch.ops import sketch as sk

    cases = shapes(4000, args.sketch_hours, torch.device("cuda", 0))
    use_libraries(None, (SOURCE,))
    want = {shape: sk.segment_udd(*a).clone() for shape, a in cases.items()}
    # the committed kernel against the plain version first
    for shape, a in cases.items():
        cs._compare_bytes(want[shape], sk.segment_udd_plain(*a), f"base {shape} against plain")
    measure("base", cases, want, args.reps)
    for name, built in libs.items():
        use_libraries(built, (SOURCE,))
        measure(name, cases, want, args.reps)
    use_libraries(None, (SOURCE,))
    measure("base", cases, want, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
