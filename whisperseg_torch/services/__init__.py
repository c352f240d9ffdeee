"""The segment service and its continuous batcher."""
