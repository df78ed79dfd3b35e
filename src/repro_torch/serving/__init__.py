"""Serving data plane of the port: the paged slot engine and the
step-plan tick loop."""
