"""Times design variants of K15's gather (csrc/gather_planes.cu) on the card,
at tools/kernel_ab.py's `gather_last` shapes: the TSBS tile cell's planes
(4000 hosts x 12 h of 10 s scrapes, 17.28 M rows in (hostname, ts) order,
padded and cut into 2^24-row chunks) through the time-major permutation
(K14's), as

* one f64 plane;
* four planes at once (f64, int32, bool, int64);
* the cell's first time-major build: 13 planes (valid, ts, hostname and
  ten f64 columns) in one `gather_planes_multi` call.

A variant is a copy of csrc/ with the gather's constants rewritten
(SOURCE_VARIANTS: kGatherCtas, the CTAs an SM; kGatherLoads, the loads a
thread keeps in flight), built by tools/radix_variants.py's `build_variants`
(one nvcc per variant, all started together) into
build/gather_variants/.  The committed kernel's outputs are held byte
for byte against the plain version, and each variant's against the
committed kernel's, before they are timed (CUDA events, the
mean of --reps calls after one warm-up); `nvcc --resource-usage` of each
variant is printed first.

Prints the card's name and power limit, then one JSON line per variant and
shape.

    python3 tools/gather_variants.py [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from radix_variants import build_variants, use_libraries  # noqa: E402

SOURCE = "gather_planes"
# name -> {constant of gather_planes.cu: value}
SOURCE_VARIANTS = {
    "ctas 8, loads 4": {"kGatherCtas": 8, "kGatherLoads": 4},
    "ctas 2, loads 16": {"kGatherCtas": 2, "kGatherLoads": 16},
}


def shapes(dev) -> dict:
    """shape -> (planes, perm) of a K15 gather call."""
    import torch

    import chip_smoke as cs
    from greptimedb_tpu_torch.ops import permute as P
    from greptimedb_tpu_torch.ops.tiles import pad_rows
    from greptimedb_tpu_torch.parallel.tile_planes import TILE_CHUNK_ROWS

    n, codes, ts, valid, vals = cs.tsbs_planes(4000, 12, 10, dev)
    npad = pad_rows(n)

    def chunk(t, fill):
        return cs._chunked(cs._padded(t, npad, fill), TILE_CHUNK_ROWS)

    codes_c, ts_c, valid_c = chunk(codes, 0), chunk(ts, 0), chunk(valid, False)
    vals_c = [chunk(v, 0.0) for v in vals]
    del codes, ts, valid, vals
    perm = P.ts_argsort(ts_c, valid_c)
    torch.cuda.synchronize()
    return {"f64": ([vals_c[0]], perm), "4 planes": ([vals_c[0], codes_c, valid_c, ts_c], perm),
            "13 planes": ([valid_c, ts_c, codes_c, *vals_c], perm)}


def _outputs(planes) -> list:
    return [c for p in planes for c in p]


def measure(name: str, cases: dict, want: dict, reps: int) -> None:
    import chip_smoke as cs

    for shape, call in cases.items():
        for a, b in zip(_outputs(call()), want[shape]):
            cs._compare_bytes(a, b, f"{name} {shape}")
        print(json.dumps({"variant": name, "shape": shape, "ms": cs._timed(call, reps)}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.modules.setdefault("jax", None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build_variants(os.path.join(ROOT, "build", "gather_variants"), SOURCE_VARIANTS,
                          f"{SOURCE}.cu", (SOURCE,))
    for name, built in libs.items():
        print(json.dumps({"variant": name, "resource_usage": built[SOURCE][1]}), flush=True)
    from greptimedb_tpu_torch.ops import permute as P

    import chip_smoke as cs

    shapes_args = shapes(torch.device("cuda", 0))
    cases = {shape: (lambda a=args_: P.gather_planes_multi(*a))
             for shape, args_ in shapes_args.items()}
    use_libraries(None, (SOURCE,))
    want = {shape: [t.clone() for t in _outputs(call())] for shape, call in cases.items()}
    # the committed kernel against the plain version first
    for shape, args_ in shapes_args.items():
        for a, b in zip(want[shape], _outputs(P.gather_planes_multi_plain(*args_))):
            cs._compare_bytes(a, b, f"base {shape} against the plain version")
    measure("base", cases, want, args.reps)
    for name, built in libs.items():
        use_libraries(built, (SOURCE,))
        measure(name, cases, want, args.reps)
    use_libraries(None, (SOURCE,))
    measure("base", cases, want, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
