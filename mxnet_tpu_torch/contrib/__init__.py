"""Contrib subset of the port: weight-only calibration."""
