"""LM stack of the port: config schema, layers, GQA attention, model."""
from .config import ModelConfig  # noqa: F401
from . import model  # noqa: F401
