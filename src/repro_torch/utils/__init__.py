"""Utilities of the port: the sharding plane (``utils.sharding``)."""
