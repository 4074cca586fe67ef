"""Literal/type coercion shared by the execution and scan-pruning paths.

Prepared-statement emulation substitutes every parameter as a quoted string
(reference servers/src/mysql/handler.rs does the same), so comparisons like
`v > '1'` against numeric columns must coerce the literal — the reference
gets this from DataFusion's type analyzer.  One helper, used by both
query/cpu_exec.py and storage/sst.py, so pruning and execution can never
disagree.
"""

from __future__ import annotations

import pyarrow as pa


def coerce_string_scalar(value, target: pa.DataType):
    """Cast a string (py str or pa string Scalar) to `target` if it is a
    numeric/bool type; returns the input unchanged when not applicable or
    unparseable (the comparison then fails with arrow's own error)."""
    is_scalar = isinstance(value, pa.Scalar)
    if is_scalar and not pa.types.is_string(value.type):
        return value
    if not is_scalar and not isinstance(value, str):
        return value
    if not (
        pa.types.is_integer(target)
        or pa.types.is_floating(target)
        or pa.types.is_boolean(target)
    ):
        return value
    try:
        return (value if is_scalar else pa.scalar(value)).cast(target)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        return value
