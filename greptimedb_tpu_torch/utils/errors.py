"""Error model.

The reference threads a structured error type through every crate
(`ErrorExt` + per-crate snafu enums, reference src/common/error/src/ext.rs).
We use a single exception hierarchy with stable status codes instead — the
codes match the reference's `StatusCode` (reference
src/common/error/src/status_code.rs) so protocol layers can map 1:1.
"""

from __future__ import annotations

import enum


class StatusCode(enum.IntEnum):
    # Keep numeric values aligned with reference status_code.rs.
    SUCCESS = 0
    UNKNOWN = 1000
    UNSUPPORTED = 1001
    UNEXPECTED = 1002
    INTERNAL = 1003
    INVALID_ARGUMENTS = 1004
    CANCELLED = 1005
    ILLEGAL_STATE = 1006

    IN_PROGRESS = 2000
    RETRY_LATER = 2001

    REGION_NOT_FOUND = 3000
    REGION_ALREADY_EXISTS = 3001
    REGION_READONLY = 3002
    REGION_NOT_READY = 3003
    REGION_BUSY = 3004
    STORAGE_UNAVAILABLE = 3005

    TABLE_ALREADY_EXISTS = 4000
    TABLE_NOT_FOUND = 4001
    TABLE_COLUMN_NOT_FOUND = 4002
    TABLE_COLUMN_EXISTS = 4003
    DATABASE_NOT_FOUND = 4004
    DATABASE_ALREADY_EXISTS = 4007

    INVALID_SYNTAX = 5001
    PLAN_QUERY = 6000
    ENGINE_EXECUTE_QUERY = 6001

    USER_NOT_FOUND = 7000
    UNSUPPORTED_PASSWORD_TYPE = 7001
    USER_PASSWORD_MISMATCH = 7002
    AUTH_HEADER_NOT_FOUND = 7003
    INVALID_AUTH_HEADER = 7004
    ACCESS_DENIED = 7005
    PERMISSION_DENIED = 7006

    FLOW_ALREADY_EXISTS = 8000
    FLOW_NOT_FOUND = 8001


class GreptimeError(Exception):
    """Base error carrying a StatusCode, like the reference's ErrorExt."""

    code: StatusCode = StatusCode.INTERNAL

    def __init__(self, msg: str = "", *, code: StatusCode | None = None):
        super().__init__(msg)
        if code is not None:
            self.code = code

    def status_code(self) -> StatusCode:
        return self.code

    def output_msg(self) -> str:
        return f"{self.code.name}: {self}"


class UnsupportedError(GreptimeError):
    code = StatusCode.UNSUPPORTED


class InvalidArgumentsError(GreptimeError):
    code = StatusCode.INVALID_ARGUMENTS


class InvalidSyntaxError(GreptimeError):
    code = StatusCode.INVALID_SYNTAX


class PlanError(GreptimeError):
    code = StatusCode.PLAN_QUERY


class ExecutionError(GreptimeError):
    code = StatusCode.ENGINE_EXECUTE_QUERY


class TableNotFoundError(GreptimeError):
    code = StatusCode.TABLE_NOT_FOUND


class TableAlreadyExistsError(GreptimeError):
    code = StatusCode.TABLE_ALREADY_EXISTS


class ColumnNotFoundError(GreptimeError):
    code = StatusCode.TABLE_COLUMN_NOT_FOUND


class DatabaseNotFoundError(GreptimeError):
    code = StatusCode.DATABASE_NOT_FOUND


class RegionNotFoundError(GreptimeError):
    code = StatusCode.REGION_NOT_FOUND


class RegionReadonlyError(GreptimeError):
    code = StatusCode.REGION_READONLY


class IllegalStateError(GreptimeError):
    code = StatusCode.ILLEGAL_STATE


class StorageError(GreptimeError):
    code = StatusCode.STORAGE_UNAVAILABLE


class QueryTimeoutError(GreptimeError):
    """A statement exceeded its cooperative deadline (utils/deadline.py).
    Deliberately NOT retried on the CPU fallback path — the deadline has
    already passed, and the fallback is exactly the unbounded scan the
    deadline exists to stop."""

    code = StatusCode.ENGINE_EXECUTE_QUERY


class ConfigError(GreptimeError):
    """Invalid or unsupported configuration value."""

    code = StatusCode.INVALID_ARGUMENTS


class RetryLaterError(GreptimeError):
    """Transient condition; the caller should retry (reference RETRY_LATER)."""

    code = StatusCode.RETRY_LATER


class FlowNotFoundError(GreptimeError):
    code = StatusCode.FLOW_NOT_FOUND


class FlowAlreadyExistsError(GreptimeError):
    code = StatusCode.FLOW_ALREADY_EXISTS
