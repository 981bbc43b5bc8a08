"""Utilities of the port: the startup memory report and the interconnect
traffic model of tensor parallelism (`telemetry`)."""
