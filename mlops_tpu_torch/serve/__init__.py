"""Serving: the quant-tier engine, the wire contract and the HTTP server."""
