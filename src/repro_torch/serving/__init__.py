"""Serving plane: the continuous-batching decode engine. The registry,
hot swap, personalization and load generator of the reference's
``repro/serving`` come with ROADMAP A16."""
from repro_torch.serving.engine import Completion, DecodeEngine, Request

__all__ = ["Completion", "DecodeEngine", "Request"]
