"""Times design variants of K7's select (csrc/topk_select.cu, cap <= 32) on
the card, and the one-launch threshold of its launch plan:

* shapes: groupby-orderby-limit's (G = 768, cap 5, an int64 key, the
  survivors a bool mask), the live HAVING query's (G = 4096 x 14, cap 10,
  the f64 max with NaN as NULL, K13's mask as the survivors, as
  chip_smoke's `select_inputs` builds them), and G = 2^18 and 2^20 of
  uniform f64 keys, cap 10, in one launch;
* variants (SOURCE_VARIANTS): copies of csrc/ with the select's constants
  rewritten (kInsertMax, the candidates of a batch inserted one by one
  rather than sorted and merged; kSelectThreads, a CTA's threads (1024
  do not fit four keys' lists in shared memory);
  kClusterCtas, the cluster's CTAs; Ahead's value, the batches a warp
  loads before it compares any), built by tools/radix_variants.py's
  `build_variants` into build/select_variants/;
* the threshold: the committed kernel at G from 2^14 to 2^22 (uniform f64
  keys, cap 10) in a grid of 1, 2, 4, 8 and 16 clusters (two launches
  past one; `topk_launch_plan` replaced for each), which set
  `TOPK_ONE_LAUNCH_GROUPS` and `_TOPK_GRID_UNITS`.

The committed kernel's outputs are held byte for byte against the plain
version, and each variant's and each grid's against the committed
kernel's, before they are timed (CUDA events, the median of five means of
--reps calls; device µs a call from torch.profiler).  Prints the card's
name and power limit, then one JSON line per variant (or grid) and shape.

    python3 tools/select_variants.py [--reps 20] [--no-sweep]
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

SOURCE = "topk_select"
# name -> {constant of topk_select.cu: value}
SOURCE_VARIANTS = {
    "always sort and merge": {"kInsertMax": 0},
    "always insert": {"kInsertMax": 32},
    "insert up to 16": {"kInsertMax": 16},
    "256 threads a CTA": {"kSelectThreads": 256},
    "4 CTAs a cluster": {"kClusterCtas": 4},
    "2 batches ahead": {"value": "NK == 1 ? 2 : 2"},
}
SWEEP_G = tuple(1 << k for k in range(14, 23))
SWEEP_UNITS = (1, 2, 4, 8, 16)


def _uniform(g: int, dev, seed: int):
    import numpy as np
    import torch

    from greptimedb_tpu_torch.ops.aggregate import HavingRef

    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.uniform(0, 100, g)).to(dev)
    m = torch.from_numpy(rng.random(g) < 0.9).to(dev)
    return m, [(HavingRef(values=v, nan_null=True), False, True)]


def shapes(dev) -> dict:
    """shape -> (gate, keys, cap)."""
    import torch

    import chip_smoke as cs

    out = {}
    surv = torch.arange(768, device=dev) < 690
    out["G=768 cap=5"] = (surv, [(torch.arange(768, dtype=torch.int64, device=dev), None, False,
                                  True)], 5)
    _prog, _args, (mask, keys, cap) = cs.select_inputs("having-or-orderby-limit", dev)
    out[f"G={mask.shape[0]} cap={cap}"] = (mask, keys, cap)
    for g in (1 << 18, 1 << 20):
        m, k = _uniform(g, dev, g)
        out[f"G={g} cap=10"] = (m, k, 10)
    return out


def measure(name: str, cases: dict, want: dict, reps: int, **kw) -> None:
    import chip_smoke as cs

    for shape, call in cases.items():
        for a, b in zip(call(), want[shape]):
            cs._compare_bytes(a, b, f"{name} {shape}")
        us, _n = _device_us(call)
        print(json.dumps({"variant": name, "shape": shape, **cs._timed_runs(call, reps),
                          "device_us": us, **kw}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("select_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.modules.setdefault("jax", None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build_variants(os.path.join(ROOT, "build", "select_variants"), SOURCE_VARIANTS,
                          f"{SOURCE}.cu", (SOURCE,))
    for name, built in libs.items():
        print(json.dumps({"variant": name, "resource_usage": built[SOURCE][1]}), flush=True)
    from greptimedb_tpu_torch.ops import aggregate as agg

    import chip_smoke as cs

    dev = torch.device("cuda", 0)

    plan = agg.topk_launch_plan

    def plan_for(units: int) -> None:
        # keyed calls in one launch, or in a grid of `units` clusters and a merge
        agg.topk_launch_plan = lambda g, cap, n_keys: (
            [("gt_topk_select", 1)] if units == 1 else
            [("gt_topk_select", units), ("gt_topk_select", 1)])
        agg._TOPK_LAYOUTS.clear()

    def use(built):
        use_libraries(built, (SOURCE,))
        agg._TOPK_LAYOUTS.clear()  # a layout holds the launch functions it took

    cases_args = shapes(dev)
    cases = {shape: (lambda g=g, k=k, c=c: agg.topk_group_select(g, k, c))
             for shape, (g, k, c) in cases_args.items()}
    plan_for(1)  # the variants: one launch at every shape
    use(None)
    want = {shape: [t.clone() for t in call()] for shape, call in cases.items()}
    for shape, (g, k, c) in cases_args.items():
        for x, y in zip(want[shape], agg.topk_group_select_plain(g, k, c)):
            cs._compare_bytes(x, y, f"base {shape} against the plain version")
    measure("base", cases, want, args.reps)
    for name, built in libs.items():
        use(built)
        measure(name, cases, want, args.reps)
    use(None)
    measure("base", cases, want, args.reps)
    if not args.no_sweep:
        for g in SWEEP_G:
            m, k = _uniform(g, dev, g + 1)
            call = {f"G={g} cap=10": lambda m=m, k=k: agg.topk_group_select(m, k, 10)}
            plan_for(1)
            base = {shape: [t.clone() for t in fn()] for shape, fn in call.items()}
            for units in SWEEP_UNITS:
                plan_for(units)
                measure(f"{units} clusters", call, base, args.reps,
                        plan=agg.topk_launch_plan(g, 10, 1))
            del m, k
    agg.topk_launch_plan = plan
    agg._TOPK_LAYOUTS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
