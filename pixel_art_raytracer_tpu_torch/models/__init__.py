"""Renderers: the deferred single frame, the frame batch and animation."""
