"""pg_strom_tpu_torch — the PyTorch/CUDA port of pg_strom_tpu.

The JAX package (`pg_strom_tpu/`) stays the reference; this package grows
beside it slice by slice, main path first, and imports `torch` but never
`jax`.  Host-only modules are copied from the reference (importing any
`pg_strom_tpu` module would import jax); each TPU Pallas kernel becomes a
hand-written Hopper kernel with a plain PyTorch version beside it.

The ported path is the pre-aggregation of one table, grouped or not:
`sql.execute` -> `plan/planner._run_agg` -> `exec/preagg_exec.PreAggExecutor`
-> either the v2 plan of `ops/preagg_fused2.derive_v2_plan` on the CUDA
kernel K1, or the expression lowering (`expr/lower_torch.py`) and a
strategy of `ops/preagg.build_preagg_fn` (column sums on K2 or K4,
scatter, sort, ungrouped) -> host absorb, merge and finalize.  Scans
(`exec/scan_exec.py`), hash joins (`exec/join_exec.py`) and the fused
join+aggregate (`exec/joinagg_exec.py`) run on the device too, the dense
join probe on the CUDA kernel K3.  The reference's SQL surface is ported
with them: window functions (`plan/window.py`), correlated subqueries
(`plan/correlated.py`), the `pgstrom_*` introspection tables
(`utils/introspect.py`), the workload models (`models/`), the SQL
generator of the differential fuzz (`utils/sqlgen.py`) and the shell
(`python -m pg_strom_tpu_torch`).  COPY rides the native parallel CSV
loader (`native/`, the reference's C++ runtime built from this package's
copy of its source), and `pg_strom.distributed` routes joins,
aggregations, stars and top-k over a single-controller device mesh
(`parallel/`, `exec/dist_exec.py`; `config.mesh_shards` shards).

The device is explicit (`config.device`, default "cuda"): with "cuda" and
no GPU the port raises; "cpu" runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

from .config import config, set_config, get_config, show_all, override  # noqa: F401
from .sqltypes import T  # noqa: F401
from .datastore import (  # noqa: F401
    Table, Column, Chunk, Database, column_from_values, column_from_numpy,
    from_reference,
)
from .errors import SqlError, CpuReCheck  # noqa: F401
# the SQL entry points; importing them here also loads sql -> plan in the
# order their mutual imports need
from .sql import execute, explain  # noqa: F401,E402
