"""Typed messages of the port: the EC sub-ops and their wire structs."""
