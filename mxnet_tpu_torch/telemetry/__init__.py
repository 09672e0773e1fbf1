"""Telemetry subset of the port: the device-memory preflight."""
from . import devstats  # noqa: F401
