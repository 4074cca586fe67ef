"""Times design variants of the port's one-sweep radix sort (csrc/radix.cuh)
on the card, at the sort shapes of chip_smoke.py:

* K14 over phase 3d's 17.28 M rows (TSBS, 4000 hosts x 12 h of 10 s ms);
* K14 over 17.28 M random ts within 1 h of ms (22 bits);
* K18 over phase 3f's minute-bucket ids (G = 720);
* K18 over 17.28 M random ids below 2^20 - 1 and below 2^24, 90 % unmasked.

Variants: the sort as committed ("base"); tiles of 256 threads x 16 keys
instead of 512 x 8 ("tile 256x16"); look-back windows of 2, 8 and 16 words
instead of 4; and the digit plan of the fewest passes of at most 11 bits,
without the rule of up to three passes of at most 8 bits ("plan min11").
A tile or window variant is a copy of csrc/ with radix.cuh's constants
rewritten, built as the port's kernels are (one nvcc per source, all
started together) into build/radix_variants/; a plan variant replaces
`radix_plan` in the wrappers.  Each variant's output is held against the
plain forms byte for byte before it is timed (CUDA events, the mean of
--reps calls after one warm-up).

Prints the card's name and power limit, then one JSON line per variant
and shape: ms, passes, key bytes and the kernels the sort launched.

    python3 tools/radix_variants.py [--reps 20]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> {constant of radix.cuh: value}
SOURCE_VARIANTS = {
    "tile 256x16": {"kThreads": 256, "kItems": 16},
    "lookback 2": {"kLookback": 2},
    "lookback 8": {"kLookback": 8},
    "lookback 16": {"kLookback": 16},
}
SOURCES = ("ts_argsort", "segment_sort")


def min11_plan(max_key: int):
    """The fewest passes of at most 11 bits, widths within one bit."""
    from greptimedb_tpu_torch.ops.radix import RadixPlan

    bits = max(max_key.bit_length(), 1)
    n = -(-bits // 11)
    widths = tuple(bits // n + (p < bits % n) for p in range(n))
    return RadixPlan(4 if bits <= 32 else 8, tuple(sum(widths[:p]) for p in range(n)), widths)


def build_variants(out_dir: str, variants: dict, edited: str, sources) -> dict:
    """variant -> {source: (library path, nvcc --resource-usage lines)}.
    Each variant is a copy of csrc/ under out_dir with the constants of
    csrc/`edited` rewritten as `variants` gives them ({constant: value});
    each of `sources` (csrc/<source>.cu) is built from it as the port's
    kernels are, every nvcc started at once.  tools/scatter_variants.py
    builds its K3 variants with it too."""
    from greptimedb_tpu_torch.kernels import _build

    procs, libs = [], {}
    for name, consts in variants.items():
        vdir = os.path.join(out_dir, re.sub(r"\W+", "_", name))
        shutil.rmtree(vdir, ignore_errors=True)
        shutil.copytree(_build.CSRC, os.path.join(vdir, "csrc"))
        path = os.path.join(vdir, "csrc", edited)
        text = open(path).read()
        for const, value in consts.items():
            text, hits = re.subn(rf"(constexpr int {const} = )[^;]+;", rf"\g<1>{value};", text)
            if hits != 1:
                raise RuntimeError(f"{edited}: no single constant {const}")
        with open(path, "w") as f:
            f.write(text)
        for src in sources:
            lib = os.path.join(vdir, f"lib{src}.so")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                   os.path.join(vdir, "csrc", f"{src}.cu")]
            procs.append((name, src, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                           stderr=subprocess.STDOUT, text=True)))
    for name, src, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} {src}.cu failed:\n{log}")
        usage = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        libs.setdefault(name, {})[src] = (lib, usage)
    return libs


def use_libraries(libs: dict | None, sources) -> None:
    """Loads a variant's libraries ({source: (path, usage)}, as
    build_variants gives them) in place of the port's for `sources`
    (None: the port's)."""
    from greptimedb_tpu_torch.kernels import _build

    for src in sources:
        _build._libs.pop(src, None)
        if libs is None:
            continue
        lib = ctypes.CDLL(libs[src][0])
        for fn in _build._EXPORTS[src]:
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            f.restype = ctypes.c_int
        _build._libs[src] = lib


def shapes(dev) -> dict:
    """shape -> (wrapper, call, plain call)."""
    import torch

    import chip_smoke as cs
    from greptimedb_tpu_torch.ops import aggregate as A
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops import permute as P
    from greptimedb_tpu_torch.ops.tiles import pad_rows
    from greptimedb_tpu_torch.parallel.tile_planes import TILE_CHUNK_ROWS

    n, _codes, ts, valid, _vals = cs.tsbs_planes(4000, 12, 0, dev)
    n = pad_rows(n)
    ts, valid = cs._padded(ts, n, 0), cs._padded(valid, n, False)
    ts_c, valid_c = cs._chunked(ts, TILE_CHUNK_ROWS), cs._chunked(valid, TILE_CHUNK_ROWS)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 99)
    hour_c = cs._chunked(cs.T0 + torch.randint(0, cs.H3600, (n,), generator=g, device=dev),
                         TILE_CHUNK_ROWS)
    hi = cs.T0 + 12 * cs.H3600
    fail = flt.mask_gids(valid, [(ts, "<", hi - 1800_000)], [], [], (ts, cs.T0, 60_000, 720), 719)
    out = {
        "K14 12 h": (P.ts_argsort, lambda: P.ts_argsort(ts_c, valid_c),
                     lambda: P.ts_argsort_plain(ts_c, valid_c)),
        "K14 1 h span": (P.ts_argsort, lambda: P.ts_argsort(hour_c, valid_c),
                         lambda: P.ts_argsort_plain(hour_c, valid_c)),
        "K18 G=720": (A.sort_segments, lambda: A.sort_segments(*fail, 720),
                      lambda: A.sort_segments_plain(*fail, 720)),
    }
    for G in ((1 << 20) - 1, 1 << 24):
        ids = torch.randint(0, G, (n,), generator=g, device=dev, dtype=torch.int32)
        mask = torch.rand(n, generator=g, device=dev) < 0.9
        out[f"K18 G={G}"] = (A.sort_segments, lambda ids=ids, mask=mask, G=G:
                             A.sort_segments(ids, mask, G),
                             lambda ids=ids, mask=mask, G=G: A.sort_segments_plain(ids, mask, G))
    return out


def measure(name: str, cases: dict, reps: int) -> None:
    import chip_smoke as cs

    for shape, (wrapper, call, plain) in cases.items():
        got, want = call(), plain()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            cs._compare_bytes(a, b, f"{name} {shape}")
        wrapper.last_sort = None
        ms = cs._timed(call, reps)
        print(json.dumps({"variant": name, "shape": shape, "ms": ms, **wrapper.last_sort}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    from greptimedb_tpu_torch.ops import aggregate as A
    from greptimedb_tpu_torch.ops import permute as P

    if not torch.cuda.is_available():
        print("radix_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build_variants(os.path.join(ROOT, "build", "radix_variants"), SOURCE_VARIANTS,
                          "radix.cuh", SOURCES)
    cases = shapes(torch.device("cuda", 0))
    use_libraries(None, SOURCES)
    measure("base", cases, args.reps)
    for name, paths in libs.items():
        use_libraries(paths, SOURCES)
        measure(name, cases, args.reps)
    use_libraries(None, SOURCES)
    base_plan = (P.radix_plan, A.radix_plan)
    P.radix_plan = A.radix_plan = min11_plan
    try:
        measure("plan min11", cases, args.reps)
    finally:
        P.radix_plan, A.radix_plan = base_plan
    measure("base", cases, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
