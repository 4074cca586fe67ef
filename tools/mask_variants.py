"""Times design variants of K1 `mask_gids` (csrc/mask_gids.cu) on the card,
at tools/kernel_ab.py's `mask_topk` shapes, each as the tile program calls
it (`lits` a view of one uploaded literal buffer):

* the TSBS tile cell's 2^24-row chunk and its 503,808-row tail (4000
  hosts x 12 h of 10 s scrapes, double-groupby's filters: ts range,
  hostname x 1 h bucket, int32 ids);
* H1's int64 ids (the container table, 5.76 M rows, three tags and the
  5-minute bucket).

A variant is a copy of csrc/ with K1's constants rewritten
(SOURCE_VARIANTS: kQuads, the quads of 4 rows a thread holds; kPreTags,
the tags whose codes load with valid and ts; kCtasPerSm, the grid's cap),
built by tools/radix_variants.py's `build_variants` into
build/mask_variants/.  The committed kernel's
outputs are held byte for byte against the plain version, and each
variant's against the committed kernel's, before they are timed (CUDA
events, the median of five means of --reps calls); `nvcc
--resource-usage` of each variant is printed first.

Prints the card's name and power limit, then one JSON line per variant and
shape.

    python3 tools/mask_variants.py [--reps 20]
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

SOURCE = "mask_gids"
# name -> {constant of mask_gids.cu: value}
SOURCE_VARIANTS = {
    "quads 2, pre 2": {"kQuads": 2, "kPreTags": 2},
    "quads 2, pre 4": {"kQuads": 2, "kPreTags": 4},
    "pre 1": {"kPreTags": 1},
    "16 CTAs an SM": {"kCtasPerSm": 16},
    "64 CTAs an SM": {"kCtasPerSm": 64},
}


def shapes(dev) -> dict:
    """shape -> (mask_gids arguments, the literal view)."""
    import torch

    import chip_smoke as cs
    from greptimedb_tpu_torch.kernels._build import upload_table
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops.tiles import pad_rows
    from greptimedb_tpu_torch.parallel.tile_planes import TILE_CHUNK_ROWS

    hosts, hours = 4000, 12
    n, codes, ts, valid, _vals = cs.tsbs_planes(hosts, hours, 0, dev)
    npad = pad_rows(n)
    codes, ts = cs._padded(codes, npad, 0), cs._padded(ts, npad, 0)
    valid = cs._padded(valid, npad, False)
    card = 1 << (hosts - 1).bit_length()
    lo, hi = cs.T0, cs.T0 + hours * cs.H3600
    table = flt.literal_table([(torch.int64, ">=", lo), (torch.int64, "<", hi)], cs.T0, cs.H3600)
    lits = upload_table(table * 2 + [0], dev)
    out = {}
    for i, o in enumerate(range(0, npad, TILE_CHUNK_ROWS)):
        v_c, t_c, c_c = (x[o:o + TILE_CHUNK_ROWS] for x in (valid, ts, codes))
        out[f"chunk {v_c.shape[0]}"] = ((v_c, [(t_c, ">=", lo), (t_c, "<", hi)], [], [(c_c, card)],
                                         (t_c, cs.T0, cs.H3600, hours), card * hours - 1),
                                        lits[i * len(table):(i + 1) * len(table)])
    _n, args = cs.h1_group_ids(cs.CM_HOURS, dev)
    h1 = flt.literal_table([(torch.int64, ">=", cs.T0),
                            (torch.int64, "<", cs.T0 + cs.CM_HOURS * cs.H3600)],
                           cs.T0, cs.CM_BUCKET_MS)
    out["int64 H1"] = (args, upload_table(h1, dev))
    torch.cuda.synchronize()
    return out


def measure(name: str, cases: dict, want: dict, reps: int) -> None:
    import chip_smoke as cs

    for shape, call in cases.items():
        for a, b in zip(call(), want[shape]):
            cs._compare_bytes(a, b, f"{name} {shape}")
        print(json.dumps({"variant": name, "shape": shape, **cs._timed_runs(call, reps)}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mask_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.modules.setdefault("jax", None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build_variants(os.path.join(ROOT, "build", "mask_variants"), SOURCE_VARIANTS,
                          f"{SOURCE}.cu", (SOURCE,))
    for name, built in libs.items():
        print(json.dumps({"variant": name, "resource_usage": built[SOURCE][1]}), flush=True)
    from greptimedb_tpu_torch.ops import filter as flt

    import chip_smoke as cs

    shapes_args = shapes(torch.device("cuda", 0))
    cases = {shape: (lambda a=a, lits=lits: flt.mask_gids(*a, lits=lits))
             for shape, (a, lits) in shapes_args.items()}

    def use(built):
        use_libraries(built, (SOURCE,))
        flt._LAYOUTS.clear()  # a layout holds the launch function it took

    use(None)
    want = {shape: [t.clone() for t in call()] for shape, call in cases.items()}
    # the committed kernel against the plain version first
    for shape, (a, _lits) in shapes_args.items():
        for x, y in zip(want[shape], flt.mask_gids_plain(*a)):
            cs._compare_bytes(x, y, f"base {shape} against the plain version")
    measure("base", cases, want, args.reps)
    for name, built in libs.items():
        use(built)
        measure(name, cases, want, args.reps)
    use(None)
    measure("base", cases, want, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
