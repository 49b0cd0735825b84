"""Optimizers of the port: the reference's SGD, Adam and AdamW rules."""
from .optimizer import SGD, Adam, AdamW, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create", "register"]
