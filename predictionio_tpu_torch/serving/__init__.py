"""HTTP layer, micro-batcher and engine server."""
