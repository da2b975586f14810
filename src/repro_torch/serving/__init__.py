"""Serving stack of the port: engine, paged KV backend, request API."""
