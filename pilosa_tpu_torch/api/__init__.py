"""HTTP API: handler and server."""
