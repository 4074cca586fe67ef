"""Times design variants of K3 `segment_reduce_scatter`
(csrc/segment_reduce_scatter.cu) on the card, at tools/kernel_ab.py's
`pack_scatter` shapes, each on a precomputed `order` (K18 apart):

* the TSBS tile shape (4000 hosts x 12 h of 10 s scrapes, 17.28 M rows in
  (hostname, ts) order), host x hour (G = 4096 x 12) at C = 1 and 10;
* minute buckets over all hosts (G = 720: 720 runs of 24,000 rows);
* host x minute (G = 4096 x 720: runs of 6 rows, the sparse ids);
* H1's 2^24 hash slot ids (5.76 M rows, runs of about 10).

A variant is a copy of csrc/ with constants of segment_reduce_scatter.cu
rewritten (SOURCE_VARIANTS: three or two CTAs an SM instead of four; one
warp of a CTA walking its tiles' long runs instead of all four; no
identities written first on sparse ids; sparse tiles of 2048 groups),
built by tools/radix_variants.py's `build_variants` (one nvcc per variant,
all started together) into build/scatter_variants/.  Each
variant's outputs are held byte for byte against the committed kernel's
before they are timed (CUDA events, the mean of --reps calls after one
warm-up); `nvcc --resource-usage` of each variant is printed first.

Prints the card's name and power limit, then one JSON line per variant and
shape.

    python3 tools/scatter_variants.py [--reps 20]
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

SOURCE = "segment_reduce_scatter"
# name -> {constant of segment_reduce_scatter.cu: value}
SOURCE_VARIANTS = {
    "min blocks 3": {"kMinBlocks": 3},
    "min blocks 2": {"kMinBlocks": 2},
    "one warp walks the runs": {"kRunWarps": 1},
    "no prewrite": {"kPrewriteBelow": 0},
    "sparse tile 2048": {"kSparseTile": 2048},
}
AGGS = ("count", "max", "min", "sum")


def shapes(dev) -> dict:
    """shape -> a K3 call on a precomputed order."""
    import torch

    import chip_smoke as cs
    from greptimedb_tpu_torch.ops import aggregate as A
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops.tiles import pad_rows

    n, codes, ts, valid, vals = cs.tsbs_planes(4000, 12, 10, dev)
    npad = pad_rows(n)
    codes, ts = cs._padded(codes, npad, 0), cs._padded(ts, npad, 0)
    valid = cs._padded(valid, npad, False)
    vals = [cs._padded(v, npad, 0.0) for v in vals]
    card, hi = 4096, cs.T0 + 12 * cs.H3600
    ids = {
        "tsbs": flt.mask_gids(valid, [(ts, ">=", cs.T0), (ts, "<", hi)], [], [(codes, card)],
                              (ts, cs.T0, cs.H3600, 12), card * 12 - 1) + (card * 12,),
        "minute G=720": flt.mask_gids(valid, [(ts, "<", hi)], [], [],
                                      (ts, cs.T0, 60_000, 720), 719) + (720,),
        "host x minute": flt.mask_gids(valid, [(ts, "<", hi)], [], [(codes, card)],
                                       (ts, cs.T0, 60_000, 720), card * 720 - 1) + (card * 720,),
    }
    out = {}
    for shape, (gids, mask, G) in ids.items():
        order = A.sort_segments(gids, mask, G)
        for C in ((1, 10) if shape == "tsbs" else (1,)):
            out[f"{shape} C={C}"] = (
                lambda gids=gids, mask=mask, G=G, order=order, C=C: A.segment_reduce_scatter(
                    vals[:C], gids, [mask] * C, mask, G, AGGS, order))
    _n, k1_args = cs.h1_group_ids(cs.CM_HOURS, dev)
    gids, mask = flt.mask_gids(*k1_args)
    H = 1 << 24
    table = torch.full((H,), A.HASH_EMPTY, dtype=torch.int64, device=dev)
    _t, slots, _o = A.hash_group_slots(table, gids, mask)
    hv = torch.rand(slots.shape[0], generator=torch.Generator(device=dev).manual_seed(cs.SEED),
                    dtype=torch.float64, device=dev) * 2e9
    order = A.sort_segments(slots, mask, H)
    out["2^24 slots C=1"] = lambda: A.segment_reduce_scatter([hv], slots, [mask], mask, H,
                                                             ("count", "max", "sum"), order)
    return out


def _outputs(st) -> list:
    return [t for t in (st.sums, st.counts, st.mins, st.maxs) if t is not None]


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
        print("scatter_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.modules.setdefault("jax", None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build_variants(os.path.join(ROOT, "build", "scatter_variants"), SOURCE_VARIANTS,
                          f"{SOURCE}.cu", (SOURCE,))
    for name, built in libs.items():
        print(json.dumps({"variant": name, "resource_usage": built[SOURCE][1]}), flush=True)
    cases = shapes(torch.device("cuda", 0))
    use_libraries(None, (SOURCE,))
    want = {shape: [t.clone() for t in _outputs(call())] for shape, call in cases.items()}
    measure("base", cases, want, args.reps)
    for name, built in libs.items():
        use_libraries(built, (SOURCE,))
        measure(name, cases, want, args.reps)
    use_libraries(None, (SOURCE,))
    measure("base", cases, want, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
