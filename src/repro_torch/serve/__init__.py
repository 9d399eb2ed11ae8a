"""Serving steps of the port: prefill and greedy decode."""
