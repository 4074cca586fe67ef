"""greptimedb_tpu_torch — the PyTorch + CUDA port of greptimedb_tpu.

The same LSM storage engine (WAL -> memtable -> Parquet SSTs, manifest
checkpointed; the on-disk layout is shared), the same SQL front end and
Arrow CPU executor, and the scan -> filter -> time-bucketed GROUP BY hot
path lowered to hand-written CUDA kernels for Hopper (sm_90a):

  csrc/       the kernels (K1 mask_gids, K2 segment_reduce_blocked,
              K3 segment_reduce_scatter, K4 segment_last; on the tile
              path K5 quantize_limbs, K6 limb_segment_sums,
              K7 topk_select, K8 pack_result)
  kernels/    nvcc build + ctypes loading, at first use
  ops/        tiling and the kernel wrappers, each beside its plain torch
              version (which a CPU tensor runs)
  parallel/   the group-by executor (one device) and the device-resident
              super-tile cache: planes, planner, program, executor
  query/      SQL parser/planner/CPU executor, device lowering
  storage/    the region engine and the per-table tag dictionaries
  database.py the standalone facade: Database(data_home, device="cuda")

The module paths mirror greptimedb_tpu/ so each counterpart is easy to
find.  Nothing here imports jax or the reference package.
"""

__version__ = "0.1.0"

from .database import Database  # noqa: E402

__all__ = ["Database", "__version__"]
